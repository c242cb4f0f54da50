"""Host-side debug rendering: counterpart of the JAX package's
`utils/render.py` (the reference's `render('rgb_array')` is a C++
TinyRenderer rasterization [ref: env_bases.py · BaseBulletEnv.render];
rendering is off the training path here).

`render_state_native` ray-traces the model's primitive geoms with the C++
renderer (`native`, `csrc/render.cpp`) from the reference camera;
`_render_state_ortho` is a numpy orthographic side view. Both read one env
of an `EnvState` on any device: its q and v come to the CPU in one copy
each, and forward kinematics runs there on CPU scalars, so a state on the
GPU renders without a device sync per element.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

from pybulletgym_tpu_torch.models.schema import GeomType
from pybulletgym_tpu_torch.ops import dynamics as dyn

# geom colors cycle (rgb in [0,1])
_PALETTE = np.array([
    [0.85, 0.35, 0.30], [0.30, 0.45, 0.85], [0.90, 0.75, 0.25],
    [0.45, 0.75, 0.40], [0.65, 0.40, 0.75], [0.35, 0.75, 0.75],
])


def _fk(task, state, env):
    """World-frame FK of env `env`, on CPU scalars."""
    q = list(state.q[:, env].cpu())
    v = list(state.v[:, env].cpu())
    return dyn.forward_kinematics(task.model, q, v, with_inertia=False)


def _pose(fk, body):
    R = np.array([float(x) for x in fk.R[body]]).reshape(3, 3)
    p = np.array([float(x) for x in fk.p[body]])
    return R, p


def _rows(m, fk):
    rows = []
    for gi, g in enumerate(m.geoms):
        if g.body == -1:
            continue
        R, p = _pose(fk, g.body)
        Rg = R @ _quat_mat(g.quat)
        gp = p + R @ g.pos
        row = np.zeros(24, np.float32)
        row[20:23] = _PALETTE[gi % len(_PALETTE)]
        if g.gtype == GeomType.SPHERE:
            row[0], row[1] = 1, float(g.size[0])
            row[2:5] = gp
        elif g.gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
            axis = Rg @ np.array([0.0, 0.0, float(g.size[1])])
            row[0], row[1] = 2, float(g.size[0])
            row[2:5] = gp - axis
            row[5:8] = gp + axis
        elif g.gtype == GeomType.BOX:
            row[0] = 4
            row[2:5] = gp
            row[8:17] = Rg.reshape(-1)
            row[17:20] = np.asarray(g.size[:3], np.float32)
        else:
            continue
        rows.append(row)
    return np.stack(rows) if rows else np.zeros((0, 24), np.float32)


def _geom_rows(task, state, env):
    """World-space primitive buffer (n, 24) for the native ray tracer."""
    return _rows(task.model, _fk(task, state, env))


def render_state_native(task, state, width: int = 320, height: int = 240,
                        env: int = 0, yaw: float = 0.0, pitch: float = -30.0,
                        dist: float = 3.0):
    """Perspective follow-camera render via the C++ ray tracer — the
    reference camera (dist 3, yaw 0, pitch −30, 320x240)
    [ref: env_bases.py · BaseBulletEnv.render]. Returns None where there is
    no g++ to build it."""
    from pybulletgym_tpu_torch.native import load_render_lib

    lib = load_render_lib()
    if lib is None:
        return None
    m = task.model
    fk = _fk(task, state, env)
    geoms = np.ascontiguousarray(_rows(m, fk), np.float32)
    base = m.body_index("torso") if _has_torso(m) else 0
    target = np.array([float(x) for x in fk.p[base]], np.float32)
    out = np.empty((height, width, 3), np.uint8)
    lib.render_rgb(
        geoms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(geoms),
        target.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(dist), ctypes.c_float(yaw), ctypes.c_float(pitch),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), width, height,
    )
    return out


def _has_torso(model) -> bool:
    return any(b.name == "torso" for b in model.bodies)


def render_state(task, state, width: int = 320, height: int = 240, env: int = 0):
    """Render one env: the native ray tracer, else (no g++) the
    orthographic view, with a warning."""
    img = render_state_native(task, state, width, height, env)
    if img is not None:
        return img
    warnings.warn("no g++ to build the native renderer; rendering an orthographic side view")
    return _render_state_ortho(task, state, width, height, env)


def _render_state_ortho(task, state, width: int = 320, height: int = 240, env: int = 0):
    """Orthographic side view (x-z plane) of one env in the batch."""
    m = task.model
    fk = _fk(task, state, env)
    img = np.full((height, width, 3), 255, np.uint8)

    # camera follows the base body, 5 m wide view
    bx = float(fk.p[0][0])
    scale = width / 5.0
    x0, z0 = bx - 2.5, -0.5

    def to_px(x, z):
        return int((x - x0) * scale), height - int((z - z0) * scale)

    # ground line
    _, gz = to_px(0, 0)
    if 0 <= gz < height:
        img[gz:min(gz + 2, height), :, :] = (120, 180, 120)

    for g in m.geoms:
        if g.body == -1:
            continue
        R, p = _pose(fk, g.body)
        gp = p + R @ g.pos
        r = float(g.size[0]) if len(g.size) else 0.05
        if g.gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
            Rg = R @ _quat_mat(g.quat)
            axis = Rg @ np.array([0, 0, float(g.size[1])])
            _line(img, to_px(gp[0] - axis[0], gp[2] - axis[2]),
                  to_px(gp[0] + axis[0], gp[2] + axis[2]),
                  max(1, int(r * scale)))
        else:
            cx, cz = to_px(gp[0], gp[2])
            _disk(img, cx, cz, max(1, int(r * scale)))
    return img


def _quat_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _disk(img, cx, cz, r):
    h, w, _ = img.shape
    for dz in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dz * dz <= r * r:
                x, z = cx + dx, cz + dz
                if 0 <= x < w and 0 <= z < h:
                    img[z, x] = (70, 70, 200)


def _line(img, p0, p1, thickness=1):
    n = max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)
    for i in range(n + 1):
        t = i / n
        x = int(p0[0] + t * (p1[0] - p0[0]))
        z = int(p0[1] + t * (p1[1] - p0[1]))
        _disk(img, x, z, thickness)
