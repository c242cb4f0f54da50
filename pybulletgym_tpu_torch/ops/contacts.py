"""Collision detection + constraint solve (contacts, friction, joint limits).

Torch counterpart of the scalar (kernel-body) path of the JAX package's
`ops.contacts`:

* **Compile-time broadphase**: the candidate contact set is a static list
  built once per model from geom contype/conaffinity masks — robot geoms vs
  world planes, plus optional explicit self-collision pairs (numpy only).
* **Analytic narrowphase** per candidate on scalar leaves.
* **PGS in Cholesky square-root space**: fixed order, fixed count (Bullet's
  `numSolverIterations=5`), pyramid friction clamped to μ·λ_n, restitution
  with a velocity threshold, and Bullet-style *split impulse*.
* **Joint limits** as unilateral velocity constraints with position feedback.

* **Reachability pruning** of self-collision pairs (`prune_pairs_by_reach`,
  `reach_bound_balls`, with `plan_row_bodies`): an offline numpy analysis,
  as in the JAX module. No plan calls it, and no step runs it.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pybulletgym_tpu_torch.models.schema import GeomType, JointType, Model
from pybulletgym_tpu_torch.ops import smath as sm
from pybulletgym_tpu_torch.ops.dynamics import _const_v3, _quat_np_to_mat


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Contact/constraint solver parameters.

    Defaults mirror the reference Bullet setup for the stadium scenes:
    5 solver iterations, contact ERP 0.9, ground restitution 0.5 and
    lateral friction 0.8 [ref: scene_bases.py · Scene; SURVEY §2.2].
    """

    iterations: int = 5
    erp: float = 0.9                 # position-correction rate (split impulse)
    limit_erp: float = 0.2           # joint-limit velocity-level ERP
    slop: float = 1e-4               # allowed penetration (m)
    restitution: float = 0.5         # floor restitution
    # Body-side restitution, Bullet's default for anything that never calls
    # changeDynamics(restitution=…) — i.e. every robot link the reference
    # loads. Bullet combines restitution MULTIPLICATIVELY
    # (btManifoldResult::calculateCombinedRestitution = e_a · e_b), so the
    # stadium ground's 0.5 × link 0.0 = 0: reference robots never bounce.
    # Raise this for genuinely bouncy bodies (tests/test_physics_units.py).
    geom_restitution: float = 0.0
    rest_threshold: float = 0.2      # min approach speed (m/s) for bounce
    floor_friction: float = 0.8      # ground lateral friction (Bullet combines
                                     # by multiplication with the geom's own)
    self_collision_pairs: Tuple[Tuple[str, str], ...] = ()
    regularization: float = 1e-9     # added to effective-mass denominators


class _FloorCand(NamedTuple):
    body: int
    local: Tuple[float, float, float]
    radius: float
    mu: float
    plane_n: Tuple[float, float, float]
    plane_d: float
    kind: str                                            # 'point' | 'disk'
    disk_axis: Optional[Tuple[float, float, float]] = None
    disk_r: float = 0.0
    geom: str = ""


class _PairCand(NamedTuple):
    body_a: int
    body_b: int
    a0: Tuple[float, float, float]
    a1: Tuple[float, float, float]
    ra: float
    b0: Tuple[float, float, float]
    b1: Tuple[float, float, float]
    rb: float
    mu: float
    geom: str = ""


def _collides(ga, gb) -> bool:
    """MuJoCo contype/conaffinity compatibility mask."""
    return bool((ga.contype & gb.conaffinity) or (gb.contype & ga.conaffinity))


def _geom_capsule_ends(g) -> List[np.ndarray]:
    r = _quat_np_to_mat(g.quat)
    axis = r @ np.array([0.0, 0.0, 1.0])
    hl = float(g.size[1])
    return [g.pos + hl * axis, g.pos - hl * axis]


def full_self_collision_pairs(model: Model, exclude_geoms: Tuple[str, ...] = ()):
    """All non-ancestor geom pairs: Bullet's URDF_USE_SELF_COLLISION |
    URDF_USE_SELF_COLLISION_EXCLUDE_ALL_PARENTS semantics
    [ref: robot_bases.py · MJCFBasedRobot.reset when self_collision=True]:
    every link pair collides except a link against any of its ancestors
    (and geoms sharing one body). Only sphere, capsule and cylinder geoms
    take part (the analytic pair narrowphase's domain)."""

    def ancestors(i):
        out = set()
        while model.bodies[i].parent >= 0:
            i = model.bodies[i].parent
            out.add(i)
        return out

    anc = {i: ancestors(i) for i in range(len(model.bodies))}
    ok_types = (GeomType.SPHERE, GeomType.CAPSULE, GeomType.CYLINDER)
    geoms = [
        g for g in model.geoms
        if g.body >= 0 and g.gtype in ok_types and g.name not in exclude_geoms
    ]
    pairs = []
    for i in range(len(geoms)):
        for j in range(i + 1, len(geoms)):
            a, b = geoms[i], geoms[j]
            if a.body == b.body:
                continue
            if a.body in anc[b.body] or b.body in anc[a.body]:
                continue
            pairs.append((a.name, b.name))
    return tuple(pairs)


# ---------------------------------------------------------------------------
# compile-time reachability pruning of self-collision pairs
# ---------------------------------------------------------------------------
#
# The static pair plan pays every candidate every substep (every env runs
# the same rows, so no per-env branch saves work): the only real lever is removing pairs
# that can NEVER touch. This is the compile-time analog of the dynamic DBVT
# broadphase culling Bullet does per step [ref: SURVEY §2.2 collision row]:
# instead of testing AABBs at runtime, we bound each geom's reachable volume
# over the WHOLE joint-limit box once, offline (no plan calls it).
#
# Method: express both geoms of a pair in their lowest-common-ancestor body
# frame (the free root joint is at/above every LCA, so base pose drops out).
# Each geom is covered by a few balls; walking a ball up one kinematic level
# applies the body's joint over its full limit interval: a rotation about
# axis u by theta in [mid-d, mid+d] maps ball (c, r) into the ball centered
# at the mid-angle position with radius r + 2*|c_perp|*sin(min(d, pi)/2)
# (the chord bound — exact for the arc's extremes), then the static
# pos/quat offset into the parent frame. The result is a rigorous outer
# bound of the geom's reachable set in the LCA frame; if the bounds of the
# two geoms stay farther apart than `clearance`, the pair's contact row can
# never produce an impulse and is dropped from the plan.
#
# Joint limits here are enforced softly (velocity-level rows, limit_erp),
# so ranges are widened by `limit_slack_frac`/`limit_slack_abs` before
# bounding; tests/test_reach_prune.py checks the slack against measured
# overshoot and samples the widened box to confirm pruned pairs never touch.


def _ball_cover_of_geom(g, k: int = 3):
    """Cover a sphere/capsule/cylinder geom with <=k balls (body frame)."""
    if g.gtype == GeomType.SPHERE:
        return [(np.asarray(g.pos, np.float64), float(g.size[0]))]
    axis = _quat_np_to_mat(g.quat) @ np.array([0.0, 0.0, 1.0])
    hl, r = float(g.size[1]), float(g.size[0])
    sub = hl / k
    return [
        (np.asarray(g.pos, np.float64) + (-hl + (2 * i + 1) * sub) * axis,
         sub + r)
        for i in range(k)
    ]


def _reach_ball_up(model, body_idx: int, ball, slack_frac: float,
                   slack_abs: float):
    """Map ball=(c, r) from body_idx's frame into its parent's frame,
    over the body's whole (widened) joint interval. None = unboundable."""
    b = model.bodies[body_idx]
    c, r = ball
    if b.jtype == JointType.FREE:
        return None
    d = b.v_adr
    if model.jnt_limited[d]:
        lo, hi = float(model.jnt_range[d, 0]), float(model.jnt_range[d, 1])
        half = (hi - lo) / 2.0
        pad = slack_frac * (hi - lo) + slack_abs
        mid = (lo + hi) / 2.0 - b.jref
        half = half + pad
    else:
        mid, half = 0.0, np.inf
    u = np.asarray(b.jaxis, np.float64)
    u = u / np.linalg.norm(u)
    if b.jtype == JointType.HINGE:
        jp = np.asarray(b.jpos, np.float64)
        rel = c - jp
        axial = (rel @ u) * u
        perp = rel - axial
        pn = float(np.linalg.norm(perp))
        # rotate rel by the mid angle (Rodrigues)
        ct, st = np.cos(mid), np.sin(mid)
        rot = rel * ct + np.cross(u, rel) * st + u * (rel @ u) * (1.0 - ct)
        c = jp + rot
        r = r + 2.0 * pn * np.sin(min(half, np.pi) / 2.0)
    else:  # SLIDE
        if not np.isfinite(half):
            return None
        c = c + u * mid
        r = r + half
    c = np.asarray(b.pos, np.float64) + _quat_np_to_mat(b.quat) @ c
    return c, r


def _lca(model, a: int, b: int):
    anc_a = []
    i = a
    while i >= 0:
        anc_a.append(i)
        i = model.bodies[i].parent
    seen = set(anc_a)
    i = b
    while i >= 0:
        if i in seen:
            return i
        i = model.bodies[i].parent
    return None


def reach_bound_balls(model, geom, lca: int, *, slack_frac: float = 0.2,
                      slack_abs: float = 0.15, cover: int = 3):
    """Outer ball bounds of `geom`'s reachable set in the `lca` body frame
    over the widened joint-limit box, or None if unboundable."""
    balls = _ball_cover_of_geom(geom, cover)
    i = geom.body
    while i != lca:
        nxt = []
        for ball in balls:
            up = _reach_ball_up(model, i, ball, slack_frac, slack_abs)
            if up is None:
                return None
            nxt.append(up)
        balls = nxt
        i = model.bodies[i].parent
    return balls


def prune_pairs_by_reach(
    model,
    pairs: Tuple[Tuple[str, str], ...],
    *,
    clearance: float = 0.03,
    slack_frac: float = 0.2,
    slack_abs: float = 0.15,
    cover: int = 3,
) -> Tuple[Tuple[Tuple[str, str], ...], Tuple[Tuple[str, str], ...]]:
    """Split `pairs` into (kept, pruned): pruned pairs provably stay
    > clearance apart for every configuration in the widened joint-limit
    box, so their PGS rows would clamp to zero impulse forever."""
    byname = {g.name: g for g in model.geoms}
    kept, pruned = [], []
    cache = {}
    for na, nb in pairs:
        ga, gb = byname[na], byname[nb]
        lca = _lca(model, ga.body, gb.body)
        if lca is None:
            kept.append((na, nb))
            continue

        def bound(g):
            key = (g.name, lca)
            if key not in cache:
                cache[key] = reach_bound_balls(
                    model, g, lca, slack_frac=slack_frac,
                    slack_abs=slack_abs, cover=cover,
                )
            return cache[key]

        ba, bb = bound(ga), bound(gb)
        if ba is None or bb is None:
            kept.append((na, nb))
            continue
        dmin = min(
            float(np.linalg.norm(ca - cb)) - ra - rb
            for ca, ra in ba
            for cb, rb in bb
        )
        (pruned if dmin > clearance else kept).append((na, nb))
    return tuple(kept), tuple(pruned)


def build_contact_plan(model: Model, cfg: SolverConfig):
    """Static candidate list: the compile-time analog of Bullet's DBVT broadphase,
    run once at model-build time (SURVEY §2.2 'compile-time broadphase')."""
    planes = [g for g in model.geoms if g.gtype == GeomType.PLANE and g.body == -1]
    floor_cands: List[_FloorCand] = []
    for pl in planes:
        rp = _quat_np_to_mat(pl.quat)
        n = rp @ np.array([0.0, 0.0, 1.0])
        d = float(n @ pl.pos)
        n_t = (float(n[0]), float(n[1]), float(n[2]))
        for g in model.geoms:
            if g.body == -1 or not _collides(g, pl):
                continue
            mu = float(g.friction) * cfg.floor_friction
            if g.gtype == GeomType.SPHERE:
                pts = [(g.pos, float(g.size[0]))]
            elif g.gtype == GeomType.CAPSULE:
                pts = [(p, float(g.size[0])) for p in _geom_capsule_ends(g)]
            elif g.gtype == GeomType.BOX:
                hx, hy, hz = (float(s) for s in g.size)
                rg = _quat_np_to_mat(g.quat)
                pts = [
                    (g.pos + rg @ np.array([sx * hx, sy * hy, sz * hz]), 0.0)
                    for sx in (-1, 1)
                    for sy in (-1, 1)
                    for sz in (-1, 1)
                ]
            elif g.gtype == GeomType.CYLINDER:
                rg = _quat_np_to_mat(g.quat)
                axis = rg @ np.array([0.0, 0.0, 1.0])
                hl, rr = float(g.size[1]), float(g.size[0])
                for sgn in (-1.0, 1.0):
                    c = g.pos + sgn * hl * axis
                    floor_cands.append(
                        _FloorCand(
                            g.body,
                            (float(c[0]), float(c[1]), float(c[2])),
                            0.0,
                            mu,
                            n_t,
                            d,
                            "disk",
                            (float(axis[0]), float(axis[1]), float(axis[2])),
                            rr,
                            g.name,
                        )
                    )
                continue
            else:
                continue
            for p, r in pts:
                floor_cands.append(
                    _FloorCand(
                        g.body,
                        (float(p[0]), float(p[1]), float(p[2])),
                        float(r),
                        mu,
                        n_t,
                        d,
                        "point",
                        geom=g.name,
                    )
                )

    pair_cands: List[_PairCand] = []
    byname = {g.name: g for g in model.geoms}
    for na, nb in cfg.self_collision_pairs:
        ga, gb = byname[na], byname[nb]

        def seg(g):
            if g.gtype == GeomType.SPHERE:
                p = tuple(float(x) for x in g.pos)
                return p, p, float(g.size[0])
            # CYLINDER is approximated by its inscribed capsule: exact for
            # side contacts (how the Pusher object is pushed), rounded at
            # the end caps (documented deviation from Bullet narrowphase).
            if g.gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
                e = _geom_capsule_ends(g)
                return (
                    tuple(float(x) for x in e[0]),
                    tuple(float(x) for x in e[1]),
                    float(g.size[0]),
                )
            raise ValueError(f"self-collision geom {g.name}: unsupported type")

        a0, a1, ra = seg(ga)
        b0, b1, rb = seg(gb)
        pair_cands.append(
            _PairCand(ga.body, gb.body, a0, a1, ra, b0, b1, rb,
                      float(ga.friction) * float(gb.friction), ga.name)
        )
    return floor_cands, pair_cands


def plan_rows(plan) -> int:
    floor_cands, pair_cands = plan
    n = 0
    for c in floor_cands:
        n += 4 if c.kind == "disk" else 1
    return n + len(pair_cands)


def plan_row_bodies(plan) -> Tuple[int, ...]:
    """Primary body index per contact row (for contact-flag reporting, the
    `p.getContactPoints` replacement)."""
    floor_cands, pair_cands = plan
    out = []
    for c in floor_cands:
        out.extend([c.body] * (4 if c.kind == "disk" else 1))
    out.extend([c.body_a for c in pair_cands])
    return tuple(out)


def plan_row_geoms(plan) -> Tuple[str, ...]:
    """Primary geom name per contact row (for foot-contact observation)."""
    floor_cands, pair_cands = plan
    out = []
    for c in floor_cands:
        out.extend([c.geom] * (4 if c.kind == "disk" else 1))
    out.extend([c.geom for c in pair_cands])
    return tuple(out)


# ---------------------------------------------------------------------------
# runtime narrowphase: scalar per candidate
# ---------------------------------------------------------------------------


def _tangent_basis_static(n):
    nn = np.array(n)
    ref = np.array([1.0, 0.0, 0.0]) if abs(nn[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    t1 = np.cross(nn, ref)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(nn, t1)
    return t1, t2


def _anc_weight(model: Model, body_a: int, body_b: Optional[int] = None) -> np.ndarray:
    w = np.zeros(model.nv, dtype=np.float32)
    for d in model.ancestor_dofs[body_a]:
        w[d] += 1.0
    if body_b is not None:
        for d in model.ancestor_dofs[body_b]:
            w[d] -= 1.0
    return w


class ScalarContacts(NamedTuple):
    """Per-candidate scalar contact data (lists over the static plan)."""

    P: list          # Vec3 per row (world contact points)
    D: list          # per row: (normal, t1, t2) Vec3 triple
    depth: list      # scalar per row
    W: list          # np (nv,) signed ancestor weights per row
    mu: list         # float per row


def narrowphase_scalar(model: Model, fk, plan) -> Optional[ScalarContacts]:
    """Candidate points/normals/depths for the static plan, as scalar lists."""
    floor_cands, pair_cands = plan
    like = fk.p[0][0]
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)

    Ps, Ds, depths, Ws, mus = [], [], [], [], []

    def emit(point, dirs, depth, w, mu):
        Ps.append(point)
        Ds.append(dirs)
        depths.append(depth)
        Ws.append(w)
        mus.append(mu)

    for c in floor_cands:
        R, p = fk.R[c.body], fk.p[c.body]
        n = _const_v3(np.array(c.plane_n))
        t1c, t2c = _tangent_basis_static(c.plane_n)
        nb = tuple(x * one for x in n)
        t1 = tuple(float(x) * one for x in t1c)
        t2 = tuple(float(x) * one for x in t2c)
        w = _anc_weight(model, c.body)
        if c.kind == "point":
            x = sm.v3_add(p, sm.m3_vec(R, _const_v3(np.array(c.local))))
            depth = (c.plane_d + c.radius) - sm.v3_dot(n, x)
            surf = sm.v3_sub(x, sm.v3_scale(n, c.radius))
            emit(surf, (nb, t1, t2), depth, w, c.mu)
        else:  # cylinder end-cap: 4 rim candidates
            cen = sm.v3_add(p, sm.m3_vec(R, _const_v3(np.array(c.local))))
            wax = sm.m3_vec(R, _const_v3(np.array(c.disk_axis)))
            nxw = sm.v3_cross(n, wax)
            deg = sm.v3_norm2(nxw)
            fallback = (R[0], R[3], R[6])
            ok = deg > 1e-10
            e1 = sm.v3_where(ok, sm.v3_scale(nxw, 1.0 / torch.sqrt(deg + 1e-12)), fallback)
            e2 = sm.v3_cross(wax, e1)
            for ex, sgn in ((e1, 1.0), (e1, -1.0), (e2, 1.0), (e2, -1.0)):
                x = sm.v3_add(cen, sm.v3_scale(ex, sgn * c.disk_r))
                depth = c.plane_d - sm.v3_dot(n, x)
                emit(x, (nb, t1, t2), depth, w, c.mu)

    for c in pair_cands:
        Ra, pa = fk.R[c.body_a], fk.p[c.body_a]
        Rb, pb = fk.R[c.body_b], fk.p[c.body_b]
        a0 = sm.v3_add(pa, sm.m3_vec(Ra, _const_v3(np.array(c.a0))))
        a1 = sm.v3_add(pa, sm.m3_vec(Ra, _const_v3(np.array(c.a1))))
        b0 = sm.v3_add(pb, sm.m3_vec(Rb, _const_v3(np.array(c.b0))))
        b1 = sm.v3_add(pb, sm.m3_vec(Rb, _const_v3(np.array(c.b1))))
        ca, cb = _segment_closest(a0, a1, b0, b1)
        dvec = sm.v3_sub(ca, cb)
        dist = sm.v3_norm(dvec, 1e-12)
        n = sm.v3_scale(dvec, 1.0 / dist)  # points from b into a
        depth = (c.ra + c.rb) - dist
        mid = sm.v3_lerp(
            sm.v3_sub(ca, sm.v3_scale(n, c.ra)), sm.v3_add(cb, sm.v3_scale(n, c.rb)), 0.5
        )
        use_x = torch.abs(n[0]) < 0.9
        ref = sm.v3_where(use_x, (one, zero, zero), (zero, one, zero))
        t1 = sm.v3_normalize(sm.v3_cross(n, ref))
        t2 = sm.v3_cross(n, t1)
        emit(mid, (n, t1, t2), depth, _anc_weight(model, c.body_a, c.body_b), c.mu)

    if not Ps:
        return None
    return ScalarContacts(Ps, Ds, depths, Ws, mus)


def _segment_closest(a0, a1, b0, b1):
    """Closest points between segments [a0,a1], [b0,b1] (branchless clamp)."""
    d1 = sm.v3_sub(a1, a0)
    d2 = sm.v3_sub(b1, b0)
    r = sm.v3_sub(a0, b0)
    a = sm.v3_norm2(d1)
    e = sm.v3_norm2(d2)
    f = sm.v3_dot(d2, r)
    cdot = sm.v3_dot(d1, r)
    b = sm.v3_dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12, torch.clamp((b * f - cdot * e) / (denom + 1e-20), 0.0, 1.0), 0.0)
    t = (b * s + f) / (e + 1e-20)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t - cdot) / (a + 1e-20), 0.0, 1.0)
    return sm.v3_add(a0, sm.v3_scale(d1, s)), sm.v3_add(b0, sm.v3_scale(d2, t))


# ---------------------------------------------------------------------------
# joint limits (packed static arrays)
# ---------------------------------------------------------------------------


class LimitPlan(NamedTuple):
    dof: np.ndarray     # (L,) int
    qadr: np.ndarray    # (L,) int
    sign: np.ndarray    # (L,) +1 lower / -1 upper
    bound: np.ndarray   # (L,)


def build_limit_plan(model: Model) -> Optional[LimitPlan]:
    dof, qadr, sign, bound = [], [], [], []
    q_of_dof = {}
    for b in model.bodies:
        if b.jtype != JointType.FREE:
            q_of_dof[b.v_adr] = b.q_adr
    for d in range(model.nv):
        if model.jnt_limited[d]:
            lo, hi = float(model.jnt_range[d, 0]), float(model.jnt_range[d, 1])
            dof += [d, d]
            qadr += [q_of_dof[d], q_of_dof[d]]
            sign += [1.0, -1.0]
            bound += [lo, hi]
    if not dof:
        return None
    return LimitPlan(
        np.array(dof), np.array(qadr), np.array(sign, np.float32), np.array(bound, np.float32)
    )


# ---------------------------------------------------------------------------
# PGS in square-root space, looped per row (the kernel-body path)
# ---------------------------------------------------------------------------


def scalar_jacobians(model: Model, fk, sc: ScalarContacts):
    """Per-row (Jn, Jt1, Jt2) as nv-lists with 0.0 structural zeros.
    The per-dof contact-point velocity basis (lin + ang × P) is shared
    across the three directions — one cross product per (row, dof)."""
    out = []
    for P, dirs, w in zip(sc.P, sc.D, sc.W):
        rows = tuple([0.0] * model.nv for _ in range(3))
        for d in range(model.nv):
            wd = float(w[d])
            if wd == 0.0:
                continue
            ang, lin = fk.S[d]
            vel = sm.v3_add(lin, sm.v3_cross(ang, P))
            for i, direction in enumerate(dirs):
                rows[i][d] = wd * sm.v3_dot(direction, vel)
        out.append(rows)
    return out


def _sdot(J, v):
    s = None
    for a, b in zip(J, v):
        if isinstance(a, float) and a == 0.0:
            continue
        if isinstance(b, float) and b == 0.0:
            continue
        t = a * b
        s = t if s is None else s + t
    return s


def _sapply(v, w, dlam):
    for d in range(len(v)):
        wd = w[d]
        if isinstance(wd, float) and wd == 0.0:
            continue
        v[d] = v[d] + wd * dlam


def solve_scalar(
    model: Model,
    cfg: SolverConfig,
    dt: float,
    sc: Optional[ScalarContacts],
    y_rows,     # per row: (yn, yt1, yt2) nv-lists = L⁻¹Jᵀ, or None
    lim: Optional[LimitPlan],
    y_lim,      # per limit row: nv-list = L⁻¹ e_dof, or None
    q: list,
    v: list,    # z = Lᵀ·(velocity after unconstrained update), nv-list
):
    """PGS in Cholesky square-root space, looped row by row: rows
    are forward-solved only (y = L⁻¹Jᵀ), the sweep runs on z = Lᵀv where
    J·v = yᵀz and impulses are z += yΔλ, and the caller back-substitutes
    the returned z once. Effective masses JM⁻¹Jᵀ = |y|². Exactly the same
    fixed point as the v-space sweep, at roughly half the per-row
    triangular-solve cost — and y's support (the subtree closure of J's)
    is narrower than M⁻¹Jᵀ's (ancestor closure), so sweeps touch fewer
    dofs too. Returns (z', z_pseudo, contact_lambda_n list)."""
    nv = model.nv
    like = v[0]
    zero = torch.zeros_like(like)
    v = list(v)
    vp = [zero] * nv

    sol = []
    if sc is not None:
        for r in range(len(sc.P)):
            yn, yt1, yt2 = y_rows[r]
            dn = 1.0 / (_sdot(yn, yn) + cfg.regularization)
            dt1 = 1.0 / (_sdot(yt1, yt1) + cfg.regularization)
            dt2 = 1.0 / (_sdot(yt2, yt2) + cfg.regularization)
            vn_pre = _sdot(yn, v)
            depth = sc.depth[r]
            e_comb = cfg.restitution * cfg.geom_restitution
            if e_comb == 0.0:
                # reference case: Bullet-combined restitution 0 (ground 0.5
                # × link 0.0) — contacts absorb impacts
                b_vel = torch.where(depth > 0.0, zero, depth / dt)
            else:
                bounce = torch.where(
                    vn_pre < -cfg.rest_threshold, -e_comb * vn_pre, zero
                )
                # impact restitution for speculative rows: a gap that closes
                # within this step bounces
                touching = depth >= vn_pre * dt
                b_vel = torch.where(
                    depth > 0.0, bounce,
                    torch.where((bounce > 0.0) & touching, bounce, depth / dt),
                )
            b_pos = (cfg.erp / dt) * (depth - cfg.slop)
            sol.append((yn, yt1, yt2, dn, dt1, dt2, b_vel, b_pos, sc.mu[r]))

    lsol = []
    if lim is not None:
        for i in range(lim.dof.shape[0]):
            d = int(lim.dof[i])
            w = y_lim[i]
            dinv = 1.0 / (_sdot(w, w) + cfg.regularization)
            sign = float(lim.sign[i])
            viol = sign * (float(lim.bound[i]) - q[int(lim.qadr[i])])
            b = (cfg.limit_erp / dt) * viol
            lsol.append((d, sign, w, dinv, b))

    lam_n = [zero] * len(sol)
    lam_t1 = [zero] * len(sol)
    lam_t2 = [zero] * len(sol)
    lam_p = [zero] * len(sol)
    lam_l = [zero] * len(lsol)

    for _ in range(cfg.iterations):
        for i, (yn, yt1, yt2, dn, dt1, dt2, b_vel, b_pos, mu) in enumerate(sol):
            vn = _sdot(yn, v)
            new = torch.clamp_min(lam_n[i] + (b_vel - vn) * dn, 0.0)
            _sapply(v, yn, new - lam_n[i])
            lam_n[i] = new
            hi = mu * new
            vt = _sdot(yt1, v)
            new = torch.clamp(lam_t1[i] - vt * dt1, -hi, hi)
            _sapply(v, yt1, new - lam_t1[i])
            lam_t1[i] = new
            vt = _sdot(yt2, v)
            new = torch.clamp(lam_t2[i] - vt * dt2, -hi, hi)
            _sapply(v, yt2, new - lam_t2[i])
            lam_t2[i] = new
            vpn = _sdot(yn, vp)
            new = torch.clamp_min(lam_p[i] + (b_pos - vpn) * dn, 0.0)
            _sapply(vp, yn, new - lam_p[i])
            lam_p[i] = new
        for i, (d, sign, w, dinv, b) in enumerate(lsol):
            vd = sign * _sdot(w, v)
            new = torch.clamp_min(lam_l[i] + (b - vd) * dinv, 0.0)
            _sapply(v, w, sign * (new - lam_l[i]))
            lam_l[i] = new

    return v, vp, lam_n
