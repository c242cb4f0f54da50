"""CUDA engine: the env step as hand-written kernels for Hopper (sm_90a).

Counterpart of the JAX package's `ops/pallas_engine.py`:

* `make_cuda_physics_step(model, cfg)` replaces `make_pallas_physics_step`:
  frame_skip substeps of FK -> RNE/CRBA -> factorization of M ->
  narrowphase -> square-root-space PGS -> semi-implicit Euler, a group of G
  lanes of one warp per env.
* `make_cuda_env_step(task)` replaces `make_pallas_env_step`: the whole env
  step (auto-reset with Threefry draws, the pre-physics hook, torques,
  substeps, obs/reward/termination, NaN guard, step count, truncation) in
  one launch, for the task classes of TASK_KINDS (`env_kernel_supports`);
  any other task's hooks are translated into `task_step_kernel`
  (`ops/task_kernel.py`), also one launch a step.

The kernels' source is `csrc/engine_core.h` (the algorithm, table-driven,
`__host__ __device__`) and `csrc/engine.cu` (two thin `__global__` kernels
and their `extern "C"` launchers). `pack_tables` flattens the frozen
`Model`, the contact and limit plans and the task constants into one
fixed-size `Tables` struct, whose layout is parsed from the header; it
picks the group width G (`lanes`, `pick_lanes`) and lays out each env's
scratch from the model's sizes (`scratch_layout`): in every class M = L^T L
over the dof tree's root paths, L by ancestor rows and each constraint row
over its support (`_path_storage`).

The tables come in four size classes (`tables_type`, `tables_class`):
the default, a `__grid_constant__` kernel parameter; the large class for
models over its caps (up to 64 bodies and nv 64; `CAPS_BIG`), built with
`-DENG_BIG_TABLES`, whose kernels read a copy of the tables in global
memory that the wrapper uploads once (`_tables_args`); the huge class (up
to 128 bodies and nv 128; `CAPS_HUGE`), built with `-DENG_HUGE_TABLES`, for
models over the large caps or whose one-env scratch outgrows a block's
shared memory; and the sized class (`CAPS_SIZED`), built with
`-DENG_SIZED_TABLES` and caps set from the model's own sizes (`sized_caps`,
given as `-DSIZED_MAX_*`), for a model over the huge caps or whose scratch
outside Y outgrows shared memory: no model size is refused. The huge and
sized classes read their tables from global memory too. The large, huge and
sized classes (the global classes) keep their whole scratch in a device
buffer of B envs' slices (`_buffer_args`, `buffer_floats`), hold a PGS
row by its window of two mask words (engine_core.h · pgs_sweeps_win), and
build `physics_step_kernel` and `task_step_kernel`; `env_step_kernel`'s
task classes all fit the default one.

One library per group width in `LANE_WIDTHS` and class (in the sized class,
and its caps) is built at first use with nvcc into `_build/` (keyed by the
sources' content hash and the flags; the builds run in parallel) and
loaded with ctypes. Each wrapper
checks its tensors, allocates outputs with `torch.empty` and launches on
the current stream without synchronising, with the envs-per-block that `launch_config` picks
from the occupancy API. A CPU tensor goes to the plain PyTorch version; a
CUDA tensor launches the kernel or raises. There is no fallback.

`HostTwin` builds the same core with g++ for the CPU tests only.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pybulletgym_tpu_torch.models.schema import JointType, Model
from pybulletgym_tpu_torch.ops import contacts as ct
from pybulletgym_tpu_torch.ops.dynamics import _quat_np_to_mat
from pybulletgym_tpu_torch.ops.step import PhysicsConfig, make_physics_step_plain, sc_rows

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# The task kinds of engine_core.h (TASK_*), and for each the aux keys and
# reward-component keys its routines write; the kernel keeps both in sorted
# key order, one slot table each (ax_*, cp_*).
_WALKER_AUX = ("initial_z", "potential", "target_x", "target_y")
_WALKER_COMPS = ("alive", "electricity", "feet_collision", "joints_at_limit", "progress")
_FLAG_AUX = ("flag_count", "flag_timeout")
_ARM_COMPS = ("ctrl", "dist", "near")
_MJ_COMPS = ("alive", "ctrl_cost", "forward")
TASK_KINDS = {  # class name -> (kind, aux keys, reward keys)
    "WalkerTask": (0, _WALKER_AUX, _WALKER_COMPS),
    "HumanoidFlagrunTask": (1, _WALKER_AUX + _FLAG_AUX, _WALKER_COMPS),
    "HumanoidFlagrunHarderTask": (2, _WALKER_AUX + _FLAG_AUX + ("frame", "ground_counter"),
                                  _WALKER_COMPS),
    "ReacherTask": (3, ("potential",), ("electricity", "progress", "stuck_joint")),
    "PusherTask": (4, (), _ARM_COMPS),
    "StrikerTask": (5, ("min_dist", "strike_x", "strike_y", "strike_z", "striked"), _ARM_COMPS),
    "ThrowerTask": (6, ("hit", "hit_x", "hit_y"), ("ctrl", "dist")),
    "InvertedPendulumTask": (7, (), ("reward",)),
    "InvertedDoublePendulumTask": (8, (), ("alive", "dist_penalty", "vel_penalty")),
    # mujoco_family.py: the walkers share one kind, their differences in tables
    "HopperMuJoCoTask": (9, ("x",), _MJ_COMPS),
    "Walker2DMuJoCoTask": (9, ("x",), _MJ_COMPS),
    "HalfCheetahMuJoCoTask": (9, ("x",), _MJ_COMPS),
    "AntMuJoCoTask": (9, ("x",), _MJ_COMPS),
    "HumanoidMuJoCoTask": (9, ("x",), _MJ_COMPS),
    "ReacherMuJoCoTask": (10, (), ("ctrl", "dist")),
    "InvertedPendulumMuJoCoTask": (11, (), ("reward",)),
    "InvertedDoublePendulumMuJoCoTask": (12, (), ("alive", "dist_penalty", "vel_penalty")),
}
# every aux and reward key the kernels know
AUX_KEYS = tuple(sorted({k for _, aux, _ in TASK_KINDS.values() for k in aux}))
COMP_KEYS = tuple(sorted({k for _, _, comps in TASK_KINDS.values() for k in comps}))

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")
# The size classes of the tables (engine_core.h): their build flags (the
# sized class's caps follow as -D values: `class_flags`), the suffix of their
# kernels' names in LAUNCHES and of their libraries' names
DEFAULT, LARGE, HUGE, SIZED = 0, 1, 2, 3
BIG_FLAG = "-DENG_BIG_TABLES"
HUGE_FLAG = "-DENG_HUGE_TABLES"
SIZED_FLAG = "-DENG_SIZED_TABLES"
CLASS_FLAGS = ((), (BIG_FLAG,), (HUGE_FLAG,), (SIZED_FLAG,))
KERNEL_SUFFIX = ("", "_large", "_huge", "_sized")
_LIB_SUFFIX = ("", "_big", "_huge", "_sized")
CAPS_BIG = 2  # the caps_id of a model that the large class holds, and not the default one
CAPS_HUGE = 3  # ... that only the huge class holds
CAPS_SIZED = 4  # ... that only a class sized to it holds
# The sized class's caps, in the order of `sized_caps`' tuple (engine_core.h's
# SIZED_MAX_*), and the multiple each is rounded up to, so that models of
# similar sizes share a library
SIZED_CAPS = ("BODIES", "NV", "NQ", "ROWS", "PAIRS", "LIMITS", "ACT", "PARTS", "DRAWS")
SIZED_ROUND = 32

_CTYPES = {"int32_t": ctypes.c_int32, "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}


# ---------------------------------------------------------------------------
# the Tables struct, mirrored from csrc/engine_core.h
# ---------------------------------------------------------------------------


def tables_type(size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None):
    """ctypes mirror of `eng::Tables` and the header's caps, parsed from
    engine_core.h (the single source of the layout), for the size class
    `size`: DEFAULT, LARGE (or True; -DENG_BIG_TABLES, whose caps the header
    names BIG_MAX_*), HUGE (-DENG_HUGE_TABLES, HUGE_MAX_*) or SIZED
    (-DENG_SIZED_TABLES, with `caps`: the tuple of `sized_caps`, which the
    build takes as -DSIZED_MAX_*). One class object for each (and each
    sized caps)."""
    size = int(size)
    if size not in (DEFAULT, LARGE, HUGE, SIZED):
        raise ValueError(f"size class {size}: DEFAULT, LARGE, HUGE or SIZED")
    if (size == SIZED) != (caps is not None):
        raise ValueError("the sized class, and only it, takes caps (sized_caps)")
    return _tables_type(size, None if caps is None else tuple(int(c) for c in caps))


@functools.lru_cache(maxsize=None)
def _tables_type(size: int, sized: Optional[Tuple[int, ...]]):
    src = open(os.path.join(CSRC, "engine_core.h")).read()
    found = re.findall(r"constexpr int (\w+) = (\d+);", src)
    prefixes = ("BIG_", "HUGE_")
    caps = {k: int(v) for k, v in found if not k.startswith(prefixes)}
    if size in (LARGE, HUGE):
        pre = prefixes[size - 1]
        caps.update({k[len(pre):]: int(v) for k, v in found if k.startswith(pre)})
    elif size == SIZED:
        caps.update({"MAX_" + k: n for k, n in zip(SIZED_CAPS, sized)})
        caps["MASK_WORDS"] = _sized_mask_words(sized)
    block = src[src.index("#define ENG_TABLE_FIELDS"):src.index("// The root paths, in every class")]
    # ENG_WIN_FIELDS: the global classes' sweep windows; ENG_PATH_FIELDS: the
    # root paths of every class
    if size != DEFAULT:
        at = src.index("#define ENG_WIN_FIELDS(S, A)")
        block += src[at:src.index("#else", at)]
    at = src.index("#define ENG_PATH_FIELDS(S, A)")
    block += src[at:src.index("// The longest support", at)]
    fields = []
    for m in re.finditer(r"\b([SA])\((\w+), (\w+)(?:, ([^)]+))?\)", block):
        kind, ctype, name, count = m.groups()
        t = _CTYPES[ctype]
        if kind == "A":
            t = t * int(eval(count, {"__builtins__": {}}, caps))
        fields.append((name, t))
    name = ("Tables", "BigTables", "HugeTables", "SizedTables")[size]
    return type(name, (ctypes.Structure,), {"_fields_": fields, "size_class": size,
                                            "sized_caps": sized}), caps


def tables_class(t) -> int:
    """The size class of the tables `t`: DEFAULT, LARGE, HUGE or SIZED."""
    size = getattr(type(t), "size_class", None)
    if size is None or type(t) is not tables_type(size, tables_caps(t))[0]:
        raise TypeError(f"{type(t).__name__} is no class of the engine's tables")
    return size


def tables_caps(t) -> Optional[Tuple[int, ...]]:
    """The caps of sized tables `t` (`sized_caps`' tuple), None in the other
    classes."""
    return getattr(type(t), "sized_caps", None)


def sized_caps(nb, nq, nv, nr, npair, nl, act=0) -> Tuple[int, ...]:
    """The sized class's caps for these sizes, in SIZED_CAPS' order: each
    size rounded up to a multiple of SIZED_ROUND (at least one), actuators at
    least one a dof and part frames one a body (as the huge class's), a draw
    for every q and every dof."""
    r = lambda n: SIZED_ROUND * max(1, -(-int(n) // SIZED_ROUND))  # noqa: E731
    bodies, dofs, qs = r(nb), r(nv), r(nq)
    return (bodies, dofs, qs, r(nr), r(npair), r(nl), r(max(act, nv)), bodies, max(qs, dofs))


def _sized_mask_words(caps: Tuple[int, ...]) -> int:
    """The sized class's root-path mask words: ceil(NV / 32), at least the
    two that anc_mask and anc_mask_hi hold (a model of many bodies and few
    dofs)."""
    return max(2, -(-caps[1] // 32))


def class_flags(size: int, caps: Optional[Tuple[int, ...]] = None) -> Tuple[str, ...]:
    """The build flags of the size class `size` (the sized class's with its
    `caps` as -DSIZED_MAX_* and its mask words)."""
    if size != SIZED:
        return CLASS_FLAGS[size]
    return (SIZED_FLAG, *(f"-DSIZED_MAX_{k}={n}" for k, n in zip(SIZED_CAPS, caps)),
            f"-DSIZED_MASK_WORDS={_sized_mask_words(caps)}")


def _set(arr, values, cap, what):
    values = list(values)
    if len(values) > cap:
        raise ValueError(f"{what}: {len(values)} entries exceed the kernel cap {cap}")
    for k, x in enumerate(values):
        arr[k] = x


def _f32(x) -> float:
    return float(np.float32(x))


def _root_path_words(dofs, words: int = 2) -> Tuple[int, ...]:
    """A body's root path (its ancestor dofs) as `words` 32-bit mask words
    (the class's MASK_WORDS; word w holds dofs 32 w .. 32 w + 31: anc_mask
    word 0, anc_mask_hi the others). Raises rather than drop a dof the
    words cannot hold."""
    mask = sum(1 << int(d) for d in dofs)
    if mask >> (32 * words):
        raise ValueError(f"dofs {sorted(int(d) for d in dofs if d >= 32 * words)} do not fit "
                         f"the root-path mask (dofs 0-{32 * words - 1})")
    return tuple(mask >> (32 * w) & 0xFFFFFFFF for w in range(words))


def _set_root_path(t, i: int, words) -> None:
    """Store body i's mask words: word w >= 1 at anc_mask_hi[(w - 1) MAX_BODIES + i]."""
    t.anc_mask[i] = words[0]
    for w in range(1, len(words)):
        t.anc_mask_hi[(w - 1) * len(t.anc_mask) + i] = words[w]


def root_path(t, i: int) -> int:
    """Body i's root-path mask from the tables' words (bit d: dof d)."""
    nb = len(t.anc_mask)
    mask = t.anc_mask[i]
    for w in range(1, len(t.anc_mask_hi) // nb + 1):
        mask |= t.anc_mask_hi[(w - 1) * nb + i] << (32 * w)
    return mask


def _composite_masses(model: Model):
    """CRBA composite masses with the plain version's arithmetic: a body's
    mass enters as a Python float (double sums) when positive and as a
    float32 zero tensor otherwise, where sums round to float32."""
    vals = [("py", float(b.mass)) if b.mass > 0.0 else ("f32", np.float32(0.0))
            for b in model.bodies]
    for i in range(len(model.bodies) - 1, -1, -1):
        p = model.bodies[i].parent
        if p != -1:
            (ka, a), (kb, b) = vals[p], vals[i]
            vals[p] = ("py", a + b) if ka == kb == "py" else ("f32", np.float32(a) + np.float32(b))
    return [_f32(v) for _, v in vals]


def _pick_caps(nb, nq, nv, nr, npair, nl, act=0, scratch_bytes=0, outside_y_bytes=0,
               path_bytes=None, longest=0) -> int:
    """The size class of these sizes: 0 (walker-sized) when they fit the
    WALKER_ caps and there are no pair rows, 1 within the default tables'
    caps, CAPS_BIG within the large class's, CAPS_HUGE within the huge
    class's; and CAPS_HUGE for any sizes whose one-env scratch
    (`scratch_bytes`, all of it, L and Y dense) outgrows a block's
    MAX_SHARED_BYTES. Above the huge caps, or where the scratch outside Y
    (`outside_y_bytes`) too outgrows a block's shared memory, CAPS_SIZED: a
    class whose caps are the sizes' own (`sized_caps`). The default class
    stores L and Y by root paths: it takes the sizes where that scratch
    (`path_bytes`, `scratch_bytes` if not given) fits a block and no row's
    support, and no dof's chain of ancestors, has more than PATH_CAP dofs
    (`longest`): the factorization and the forward solves keep them in
    registers."""
    sizes = {"BODIES": nb, "NQ": nq, "NV": nv, "ROWS": nr, "PAIRS": npair, "LIMITS": nl,
             "ACT": act}
    fits = scratch_bytes <= MAX_SHARED_BYTES
    _, caps = tables_type()
    fits_paths = (scratch_bytes if path_bytes is None else path_bytes) <= MAX_SHARED_BYTES
    if (fits_paths and longest <= caps["PATH_CAP"]
            and all(n <= caps["MAX_" + k] for k, n in sizes.items())):
        walker = all(n <= caps["WALKER_" + k] for k, n in sizes.items() if k != "PAIRS")
        return 0 if walker and npair == 0 else 1
    _, big = tables_type(LARGE)
    if fits and all(n <= big["MAX_" + k] for k, n in sizes.items()):
        return CAPS_BIG
    _, huge = tables_type(HUGE)
    if outside_y_bytes > MAX_SHARED_BYTES or any(n > huge["MAX_" + k] for k, n in sizes.items()):
        return CAPS_SIZED
    return CAPS_HUGE


def size_class(caps_id: int) -> int:
    """The tables' size class of a caps_id: DEFAULT, LARGE, HUGE or SIZED."""
    return {CAPS_BIG: LARGE, CAPS_HUGE: HUGE, CAPS_SIZED: SIZED}.get(caps_id, DEFAULT)


def _plans(model: Model, cfg: PhysicsConfig):
    """(floor candidates, pair candidates, contact rows, limit plan, limit
    rows) of the model, as the tables lay them out."""
    floor, pairs = ct.build_contact_plan(model, cfg.solver)
    lim = ct.build_limit_plan(model)
    return floor, pairs, sc_rows((floor, pairs)), lim, 0 if lim is None else int(lim.dof.shape[0])


def caps_class(model: Model, cfg: PhysicsConfig, act=0, plans=None, naux=0, obs_dim=0) -> int:
    """The caps_id of a model's tables (`_pick_caps`, with the one-env
    scratch of a kernel with `act` actions, `naux` aux slots and `obs_dim`
    observations; `plans`: the model's `_plans`, if at hand). Every model has
    one: past the huge class it is CAPS_SIZED."""
    plans = plans or _plans(model, cfg)
    floor, pairs, rows, lim, nl = plans
    nb, nr = len(model.bodies), len(rows)
    sizes = (nb, model.nq, model.nv, nr, len(pairs), nl, act, naux, obs_dim)
    shared, y = _scratch_sizes(*sizes)
    outside = sum(shared.values()) | 1
    whole = (outside + y["Y"]) | 1
    mask = [sum(1 << d for d in dofs) for dofs in model.ancestor_dofs]
    dof_body = [i for i, dofs in enumerate(model.body_dofs) for _ in dofs]
    row_masks = [(mask[c.body], 0) for c in sc_rows((floor, []))]
    row_masks += [(mask[c.body_a], mask[c.body_b]) for c in pairs]
    lim_dofs = [] if lim is None else [int(d) for d in lim.dof]
    depth, _, l_floats, row_n, lim_n = _path_sizes(model.nv, mask, dof_body, row_masks, lim_dofs)
    y_rows = _path_y(model.nv, row_n, lim_n, limit_seconds(lim_dofs))[2]
    shared, y = _scratch_sizes(*sizes, l_floats, y_rows, dofs=dof_words())
    paths = (sum(shared.values()) + y["Y"]) | 1
    return _pick_caps(nb, model.nq, model.nv, nr, len(pairs), nl, act, 4 * whole, 4 * outside,
                      4 * paths, max(row_n + lim_n + [k + 1 for k in depth], default=0))


# The group widths G that the CUDA libraries (one each) and the host twin
# are built for.
LANE_WIDTHS = (4, 8, 16, 32)


def lane_nv(G: int, size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None) -> int:
    """The most dofs the CUDA library of G lanes steps (engine_core.h ·
    lane_nv) in the size class `size` (at G=32 the class's MAX_NV: 40, 64 or
    128, or the sized class's `caps`' NV): its lanes' dof vectors are sized
    by it, and its launch refuses tables with more."""
    _, c = tables_type(size, caps)
    return c.get(f"LANE_NV_{G}", c["MAX_NV"])


def pick_lanes(nv: int, size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None) -> int:
    """The group width G for a model of nv dofs: the narrowest whose
    library holds nv dofs (4 up to 4, 8 up to 12, 16 up to 16, else 32), as
    a width sweep on the H100 ranked them (`tools/kernel_ab.py --lanes`,
    PERF.md §6). Raises above the class's MAX_NV."""
    for G in LANE_WIDTHS:
        if nv <= lane_nv(G, size, caps):
            return G
    raise NotImplementedError(f"{nv} dofs exceed the kernels' cap "
                              f"{lane_nv(LANE_WIDTHS[-1], size, caps)}")


# 227 KB: the dynamic shared memory one block may use on sm_90
MAX_SHARED_BYTES = 232448


@functools.lru_cache(maxsize=None)
def scratch_slots() -> Tuple[str, ...]:
    """The per-env scratch arrays in layout order (engine_core.h ·
    ENG_SCRATCH)."""
    src = open(os.path.join(CSRC, "engine_core.h")).read()
    block = src[src.index("#define ENG_SCRATCH(X)"):src.index("#define ENG_SLOT")]
    return tuple(re.findall(r"X\((\w+)\)", block))


# the arrays that live inside Y's rows 1.., in this order, and their floats a body
_Y_ALIAS = (("inert", 13), ("avp", 6), ("f", 6))
# the default class's PGS scalars a contact row and a limit row (engine_core.h ·
# CRow, LRow)
_CROW, _LROW = 12, 3
# an env's slice of a huge or sized class's device buffer (Y, or the whole
# scratch) is a multiple of this many floats (128 bytes)
Y_ALIGN = 32


def _scratch_sizes(nb, nq, nv, nr, npair, nl, act=0, naux=0, obs_dim=0, l_floats=None,
                   y_rows=None, dofs=0):
    """The floats of each array of one env's scratch, as two dicts: those
    that live in shared memory in every class, and {"Y": floats} (the
    forward-solved rows and, in their rows 1.., inert, avp, f and obs). L
    and Y's rows dense (nv rows of nv | 1 floats, 1 + 3 nr + nl rows of nv |
    1), unless `l_floats` and `y_rows` (the storage by root paths,
    `_path_storage`) say otherwise. `dofs`: the words a dof of the dof
    records (engine_core.h · dofs_fill, DOF_WORDS: `dof_words`) with the PGS
    scalars by row (crow, lrow: a contact row's multipliers, right-hand
    sides, inverse diagonals and Gram entries, a limit row's three) in place
    of an array each (dinv ... lam_l, then empty: no kernel reads them), as
    the kernels of every class read them since the root paths; 0 for the
    dense sizes."""
    ld = nv | 1
    rows_y = (1 + 3 * nr + nl) * ld if y_rows is None else y_rows
    pgs = {"dinv": 3 * nr, "b_vel": nr, "b_pos": nr, "dinv_l": nl, "b_l": nl,
           "lam_n": nr, "lam_t1": nr, "lam_t2": nr, "lam_p": nr, "lam_l": nl}
    shared = {
        "q": nq, "v": nv, "tau": nv, "act": act, "aux": naux, "obs": 0,
        "R": 9 * nb, "p": 3 * nb, "vel": 6 * nb, "com": 3 * nb, "S": 6 * nv,
        "inert": 0, "avp": 0, "f": 0,
        "L": nv * ld if l_floats is None else l_floats, "inv_diag": nv, "depth": nr,
        "P": 3 * nr, "dirs": 9 * npair,
        "z": nv, "zp": nv, "v3o": nv, "vp": nv, "Y": 0,
        **{k: 0 if dofs else n for k, n in pgs.items()},
        "dofs": dofs * nv,
        "crow": _CROW * nr if dofs else 0, "lrow": _LROW * nl if dofs else 0,
    }
    alias = sum(n * nb for _, n in _Y_ALIAS)
    return shared, {"Y": max(rows_y, ld + alias, ld + obs_dim)}


def dof_words(size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None) -> int:
    """The int32 words of a dof's record in the scratch (engine_core.h ·
    DOF_WORDS): four in the default class (the row of L and the model's dof
    packed in one), 3 + MASK_WORDS in the global ones."""
    return 4 if size == DEFAULT else 3 + tables_type(size, caps)[1]["MASK_WORDS"]


def with_tables(step, tables):
    """A copy of the wrapper `step` (CudaPhysicsStep or task_kernel's
    CudaTaskStep) that launches its library with `tables` (the same model's,
    edited: tools/kernel_phases.py's `stop_after` or iterations): their own
    device copy and buffers."""
    other = copy.copy(step)
    other.tables = tables
    other.device_tables, other.buffers = {}, {}
    return other


def _path_sizes(nv, body_masks, dof_body, row_masks, lim_dofs):
    """The default class's storage by root paths (engine_core.h ·
    ENG_PATH_FIELDS) from each body's root-path mask (bit d: dof d), each
    dof's body, each contact row's bodies' masks (a, b; b 0 for a floor
    row) and each limit row's dof: (each dof's depth, the offset of each
    dof's ancestor row in L, L's floats, each contact row's support size,
    each limit row's)."""
    depth = [bin(body_masks[dof_body[d]] & ((1 << d) - 1)).count("1") for d in range(nv)]
    rows = [0]
    for d in range(nv):
        rows.append(rows[-1] + depth[d] + 1)
    return (depth, rows[:nv], rows[nv], [bin(a | b).count("1") for a, b in row_masks],
            [depth[d] + 1 for d in lim_dofs])


def limit_seconds(lim_dofs) -> list:
    """Which limit rows are the second of a pair: rows m - 1 and m of one
    dof (a joint's lower and upper limit, `contacts.build_limit_plan`),
    row m - 1 not itself a second. Both rows of a pair are w = L^-T e_d: they
    share one row of Y (`_path_y`), and the PGS sweep steps the pair as one
    (engine_core.h · sweep_limits). A row without a partner stands alone."""
    second = []
    for m, d in enumerate(lim_dofs):
        second.append(m > 0 and lim_dofs[m - 1] == d and not second[m - 1])
    return second


def _path_y(nv, row_n, lim_n, lim_second=None):
    """Y's rows by root paths: (each contact row's offset, each limit row's
    and, last, the floats of Y's rows): the dynamics' dense row of nv | 1
    floats, each contact row's three directions over its support, then each
    limit row over its dof's chain, the second of a pair (`lim_second`,
    `limit_seconds`) at its first's offset."""
    y = nv | 1
    row_y = []
    for n in row_n:
        row_y.append(y)
        y += 3 * n
    lim_y = []
    for m, n in enumerate(lim_n):
        if lim_second is not None and lim_second[m]:
            lim_y.append(lim_y[-1])
            continue
        lim_y.append(y)
        y += n
    return row_y, lim_y, y


def _path_storage(t, pair_limits: bool = True) -> Tuple[int, int]:
    """Set the root paths (engine_core.h · ENG_PATH_FIELDS) from the tables'
    root-path masks, and lay out L by ancestor rows and Y's rows over their
    supports: t.dof_perm (the factor's order of the dofs: a free joint's
    linear ones before its angular ones), t.dof_depth, t.anc_row and
    t.dof_anc (each dof's ancestors), t.path_u and t.path_y (each contact
    row's support, then each limit row's: its dof's chain; each row's Y
    offset, one for both rows of a limit pair unless `pair_limits` is
    false), t.pair_pa and t.pair_na (a pair row's body a's path and its dofs
    off body b's), t.lim_steps and t.lim_first (the sweep's limit steps:
    each pair's first row, and each row without a partner); a set in the
    class's MASK_WORDS words. In the global classes also ENG_WIN_FIELDS:
    t.dof_lo (each dof's lowest ancestor, or itself), t.path_n (each row's
    support's size), t.path_w0 and t.path_w1 (the first word of its sweep
    window, at most MASK_WORDS - 2, and the last word that holds a dof of
    it), t.path_win and t.pair_win (the support's and a pair row's body a's
    words in the window), t.pair_nab (a pair row's body a's path's dofs).
    Returns (L's floats, the floats of Y's rows). A row past the
    tables' arrays (tables edited beyond their caps) has no support to read
    and counts as dense (nv dofs)."""
    nv, nfloor, caps = t.nv, t.nr - t.npair, len(t.row_body)
    words = len(t.dof_anc) // len(t.dof_depth)
    full = (1 << 32) - 1

    def put(arr, j, mask):
        for w in range(words):
            arr[words * j + w] = mask >> (32 * w) & full

    masks = [root_path(t, i) for i in range(t.nb)]
    row_masks = [(masks[t.row_body[r]], 0) if r < nfloor else
                 (masks[t.pair_a[r - nfloor]], masks[t.pair_b[r - nfloor]])
                 for r in range(min(t.nr, caps))]
    lims = [t.lim_dof[m] for m in range(min(t.nl, len(t.lim_dof)))]
    depth, rows, l_floats, row_n, lim_n = _path_sizes(nv, masks, list(t.dof_body), row_masks, lims)
    row_n += [nv] * (t.nr - len(row_masks))
    lim_n += [nv] * (t.nl - len(lims))
    second = limit_seconds(lims) if pair_limits else [False] * len(lims)
    row_y, lim_y, y = _path_y(nv, row_n, lim_n, second + [False] * (t.nl - len(lims)))
    firsts = [m for m, sec in enumerate(second) if not sec]
    t.lim_steps = len(firsts)
    for k, m in enumerate(firsts):
        t.lim_first[k] = m
    win = hasattr(t, "path_w0")
    for d in range(nv):
        anc = masks[t.dof_body[d]] & ((1 << d) - 1)
        t.dof_perm[d] = d
        t.dof_depth[d], t.anc_row[d] = depth[d], rows[d]
        put(t.dof_anc, d, anc)
        if win:
            t.dof_lo[d] = (anc & -anc).bit_length() - 1 if anc else d
    for i in range(t.nb):  # a free joint's linear dofs before its angular ones
        if t.jtype[i] == int(JointType.FREE):
            a = t.v_adr[i]
            for k in range(3):
                t.dof_perm[a + k], t.dof_perm[a + 3 + k] = a + 3 + k, a + k
    chains = [masks[t.dof_body[d]] & ((2 << d) - 1) for d in lims]
    rows = [(r, a | b, row_y[r]) for r, (a, b) in enumerate(row_masks)]
    rows += [(t.nr + m, u, lim_y[m]) for m, u in enumerate(chains)]
    for j, u, off in rows:
        if j < len(t.path_y):
            put(t.path_u, j, u)
            t.path_y[j] = off
            if win:
                first = ((u & -u).bit_length() - 1) // 32 if u else 0
                w0 = min(first, words - 2)
                t.path_n[j] = bin(u).count("1")
                t.path_w0[j] = w0
                t.path_w1[j] = max((u.bit_length() - 1) // 32, w0) if u else w0
                t.path_win[2 * j], t.path_win[2 * j + 1] = u >> 32 * w0 & full, u >> 32 * w0 + 32 & full
    for r in range(nfloor, len(row_masks)):
        a, b = row_masks[r]
        k = r - nfloor
        put(t.pair_pa, k, a)
        t.pair_na[k] = bin(a & ~b).count("1")
        if win:
            w0 = t.path_w0[r]
            t.pair_win[2 * k], t.pair_win[2 * k + 1] = a >> 32 * w0 & full, a >> 32 * w0 + 32 & full
            t.pair_nab[k] = bin(a).count("1")
    return l_floats, y


def scratch_layout(t, pair_limits: bool = True) -> Dict[str, Tuple[int, int]]:
    """Lay out one env's scratch for the tables `t` from the model's sizes:
    sets t.sc (each array's float offset), t.sc_stride, t.sc_ld and t.sc_ldm
    (nv made odd: Y's dynamics row). inert, avp, f and obs live inside Y's
    rows after the dynamics', which are dead whenever those are live. Every
    class stores L by ancestor rows and Y's rows over their supports
    (`_path_storage`, engine_core.h · ENG_PATH_FIELDS; a limit pair's two
    rows one row of Y unless `pair_limits` is false). The default class's
    scratch is a slice of shared memory (t.sc_stride odd, so that the envs
    of a warp start in different banks); the large, huge and sized classes
    lay the whole scratch out for the env's slice of the device buffer in
    global memory: t.sc_stride a multiple of Y_ALIGN floats, any size. Timed
    on an H100 against the scratch in shared memory (and in the huge class
    against Y alone in the buffer), this was the fastest on two, four and
    ten Humanoids' physics kernels at B=4096, by 1.13-5.9x, and within 0.4%
    on two Humanoids' task kernel (seven and eleven balls ran 32% and 6%
    faster in shared memory; PERF.md §6). Returns {name: (offset, floats)}.
    Raises if a scratch in shared memory does not fit one block's."""
    nv, ld = t.nv, t.nv | 1
    size = tables_class(t)
    glob = size != DEFAULT
    l_floats, y_rows = _path_storage(t, pair_limits)
    shared, y = _scratch_sizes(t.nb, t.nq, nv, t.nr, t.npair, t.nl, t.act, t.naux, t.obs_dim,
                               l_floats, y_rows, dofs=dof_words(size, tables_caps(t)))
    sizes = dict(shared, **y)
    slots = scratch_slots()
    if set(slots) != set(sizes):
        raise RuntimeError(f"engine_core.h's scratch slots {slots} differ from {sorted(sizes)}")
    out, off = {}, 0
    for name in slots:
        out[name] = (off, sizes[name])
        off += sizes[name]
    y0 = out["Y"][0] + ld
    out["obs"] = (y0, t.obs_dim)
    for name, n in _Y_ALIAS:
        out[name] = (y0, n * t.nb)
        y0 += n * t.nb
    stride = -(-off // Y_ALIGN) * Y_ALIGN if glob else off | 1
    if not glob and stride * 4 > MAX_SHARED_BYTES:
        raise NotImplementedError(f"one env's scratch ({stride * 4} bytes) exceeds a block's "
                                  f"{MAX_SHARED_BYTES} bytes of shared memory: pack_physics "
                                  "gives such a model a larger class")
    for k, name in enumerate(slots):
        t.sc[k] = out[name][0]
    t.sc_stride, t.sc_ld, t.sc_ldm = stride, ld, ld
    return out


def tables_in_class(t, size: int, caps: Optional[Tuple[int, ...]] = None):
    """A copy of the tables `t` in the larger class `size` (LARGE, HUGE or
    SIZED, the last with `caps`, by default t's own `sized_caps`): every
    array of a smaller class fits a larger one's, its entries copied in
    order, each body's root path in the class's mask words; the root paths
    and the scratch laid out again (`scratch_layout`). The same model in a
    larger class's tables, for tests and measurements; no wrapper packs
    such tables."""
    if size == SIZED and caps is None:
        caps = sized_caps(t.nb, t.nq, t.nv, t.nr, t.npair, t.nl, t.act)
    Tables, c = tables_type(size, caps)
    out = Tables()
    fields = {name for name, _ in Tables._fields_}
    for name, _ in type(t)._fields_:
        if name not in fields:
            continue
        x = getattr(t, name)
        if isinstance(x, ctypes.Array):
            ctypes.memmove(getattr(out, name), x,
                           min(ctypes.sizeof(x), ctypes.sizeof(getattr(out, name))))
        else:
            setattr(out, name, x)
    for i in range(t.nb):
        bits = root_path(t, i)
        _set_root_path(out, i, _root_path_words([d for d in range(t.nv) if bits >> d & 1],
                                                c["MASK_WORDS"]))
    out.caps_id = {LARGE: CAPS_BIG, HUGE: CAPS_HUGE, SIZED: CAPS_SIZED}[size]
    scratch_layout(out)
    return out


def unpaired_limits(t):
    """A copy of the default class's tables `t` with each limit row its own
    row of Y, laid out again (`scratch_layout(..., pair_limits=False)`): the
    storage before limit pairs, whose rows phase solves each limit row and
    whose sweep steps each limit row alone. A table edit for tests and
    measurements; no wrapper packs such tables."""
    u = type(t).from_buffer_copy(t)
    scratch_layout(u, pair_limits=False)
    return u


def dense_stride(t) -> int:
    """The floats of one env's scratch for the tables `t` with L and Y's
    rows dense (nv | 1 floats a row) and the PGS scalars an array each (the
    storage before the root paths), rounded as `scratch_layout` rounds the
    class's stride: the dense figure beside t.sc_stride."""
    shared, y = _scratch_sizes(t.nb, t.nq, t.nv, t.nr, t.npair, t.nl, t.act, t.naux, t.obs_dim)
    off = sum(shared.values()) + y["Y"]
    return -(-off // Y_ALIGN) * Y_ALIGN if tables_class(t) != DEFAULT else off | 1


def buffer_floats(t) -> int:
    """The floats of one env's slice of the device buffer that the kernels
    of the large, huge and sized classes take after the tables: the whole
    scratch (t.sc_stride); none in the default class."""
    return int(t.sc_stride) if tables_class(t) != DEFAULT else 0


def pack_physics(model: Model, cfg: PhysicsConfig, frame_skip: Optional[int] = None, act=0,
                 naux=0, obs_dim=0):
    """Physics part of the tables (model, plans, solver constants), the
    size class (`caps_id`: a model over the default caps gets the large
    class's tables, one over the large caps or whose scratch with `act`
    actions, `naux` aux slots and `obs_dim` observations outgrows shared
    memory the huge class's, one over the huge caps or whose scratch outside
    Y outgrows shared memory the sized class's, with caps from its sizes),
    the group width (`lanes`) and the scratch layout."""
    plans = _plans(model, cfg)
    floor, pairs, rows, lim, nl = plans
    caps_id = caps_class(model, cfg, act, plans, naux, obs_dim)
    size = size_class(caps_id)
    sized = (sized_caps(len(model.bodies), model.nq, model.nv, len(rows), len(pairs), nl, act)
             if size == SIZED else None)
    Tables, caps = tables_type(size, sized)
    t = Tables()
    t.caps_id = caps_id
    t.naux, t.obs_dim = naux, obs_dim
    nb = len(model.bodies)
    t.nb, t.nq, t.nv, t.nr, t.nl = nb, model.nq, model.nv, len(rows), nl
    t.npair = len(pairs)
    t.frame_skip = cfg.frame_skip if frame_skip is None else int(frame_skip)
    t.iterations = cfg.solver.iterations
    sol = cfg.solver
    e_comb = sol.restitution * sol.geom_restitution
    t.e_comb_zero = int(e_comb == 0.0)
    dt = cfg.timestep
    t.dt = _f32(dt)
    _set(t.gravity_neg, [_f32(-float(g)) for g in cfg.gravity], 3, "gravity")
    t.max_velocity = _f32(cfg.max_velocity)
    t.erp_over_dt = _f32(sol.erp / dt)
    t.slop = _f32(sol.slop)
    t.limit_erp_over_dt = _f32(sol.limit_erp / dt)
    t.reg = _f32(sol.regularization)
    t.neg_e_comb = _f32(-e_comb)
    t.neg_rest_threshold = _f32(-sol.rest_threshold)

    cmass = _composite_masses(model)
    f3 = lambda a: [_f32(float(x)) for x in np.asarray(a, np.float64).reshape(-1)]  # noqa: E731
    off_r, off_p, jpos, jaxis, com, inertia = [], [], [], [], [], []
    for i, b in enumerate(model.bodies):
        t.parent[i] = b.parent
        t.jtype[i] = int(b.jtype)
        t.q_adr[i] = b.q_adr
        t.v_adr[i] = b.v_adr
        t.has_mass[i] = int(b.mass > 0.0)
        _set_root_path(t, i, _root_path_words(model.ancestor_dofs[i], caps["MASK_WORDS"]))
        off_r += f3(_quat_np_to_mat(b.quat))
        off_p += f3(b.pos)
        jpos += f3(b.jpos)
        jaxis += f3(b.jaxis)
        t.jref[i] = _f32(b.jref)
        t.mass[i] = _f32(b.mass) if b.mass > 0.0 else 0.0
        t.cmass[i] = cmass[i]
        com += f3(b.com)
        inertia += f3(b.inertia)
    _set(t.off_r, off_r, 9 * caps["MAX_BODIES"], "off_r")
    _set(t.off_p, off_p, 3 * caps["MAX_BODIES"], "off_p")
    _set(t.jpos, jpos, 3 * caps["MAX_BODIES"], "jpos")
    _set(t.jaxis, jaxis, 3 * caps["MAX_BODIES"], "jaxis")
    _set(t.com, com, 3 * caps["MAX_BODIES"], "com")
    _set(t.inertia, inertia, 9 * caps["MAX_BODIES"], "inertia")
    for i, b in enumerate(model.bodies):
        for d in model.body_dofs[i]:
            t.dof_body[d] = i
            # free dofs have no spring: stiffness masked as step.py · _passive_tables
            t.dof_qadr[d] = 0 if b.jtype == JointType.FREE else b.q_adr
            stiff = 0.0 if b.jtype == JointType.FREE else float(model.dof_stiffness[d])
            t.neg_stiffness[d] = _f32(-stiff)
    for d in range(model.nv):
        t.neg_damping[d] = _f32(-float(model.dof_damping[d]))
        t.springref[d] = _f32(model.dof_springref[d])
        t.armature[d] = _f32(model.dof_armature[d])
    for j in range(model.nq):
        t.qpos0[j] = _f32(model.qpos0[j])

    # floor rows in plan order: a point candidate is one row, a disk (a
    # cylinder's end cap) four rim rows, (e1, +r), (e1, -r), (e2, +r), (e2, -r)
    r = 0
    for c in floor:
        n = tuple(float(x) for x in c.plane_n)
        t1, t2 = ct._tangent_basis_static(c.plane_n)
        rims = ((1, 1.0), (1, -1.0), (2, 1.0), (2, -1.0)) if c.kind == "disk" else ((0, 0.0),)
        for disk, sgn in rims:
            t.row_body[r] = c.body
            t.row_disk[r] = disk
            t.row_rim[r] = _f32(sgn * c.disk_r)
            for k in range(3):
                t.row_local[3 * r + k] = _f32(c.local[k])
                t.row_axis[3 * r + k] = _f32(c.disk_axis[k]) if disk else 0.0
                t.row_n[3 * r + k] = _f32(n[k])
                t.row_t1[3 * r + k] = _f32(t1[k])
                t.row_t2[3 * r + k] = _f32(t2[k])
                t.row_nrad[3 * r + k] = _f32(n[k] * c.radius)
            t.row_depth0[r] = _f32(c.plane_d + c.radius)
            r += 1
    for r, c in enumerate(rows):
        t.row_mu[r] = _f32(c.mu)
    for k, c in enumerate(pairs):
        t.pair_a[k], t.pair_b[k] = c.body_a, c.body_b
        for j in range(3):
            t.pair_a0[3 * k + j] = _f32(c.a0[j])
            t.pair_a1[3 * k + j] = _f32(c.a1[j])
            t.pair_b0[3 * k + j] = _f32(c.b0[j])
            t.pair_b1[3 * k + j] = _f32(c.b1[j])
        t.pair_rsum[k] = _f32(c.ra + c.rb)
        t.pair_ra[k] = _f32(c.ra)
        t.pair_rb[k] = _f32(c.rb)
    for l in range(nl):
        t.lim_dof[l] = int(lim.dof[l])
        t.lim_qadr[l] = int(lim.qadr[l])
        t.lim_sign[l] = _f32(lim.sign[l])
        t.lim_bound[l] = _f32(lim.bound[l])
    t.act = act
    t.lanes = pick_lanes(model.nv, size, sized)
    scratch_layout(t)
    return t


ALIVE_MODES = {"cheetah": 0, "hopper": 1, "ant": 2, "humanoid": 3}  # engine_core.h · ALIVE_*


def _kernel_match(task):
    """((kind, aux keys, reward keys), "") when `env_step_kernel` implements
    `task`, else (None, why): its class must be one of TASK_KINDS (not a
    subclass, whose hooks are its own), its model within the default
    tables' caps (the kernel has no large or huge build), and its hooks, probed
    once on one env, must write that kind's aux and reward keys."""
    from pybulletgym_tpu_torch.envs import locomotion, manipulation, mujoco_family, pendula

    name = type(task).__name__
    kind = TASK_KINDS.get(name)
    if kind is None or not any(getattr(mod, name, None) is type(task)
                               for mod in (locomotion, manipulation, pendula, mujoco_family)):
        return None, f"{name}: only {', '.join(TASK_KINDS)} are in the env-step kernel"
    size = size_class(caps_class(task.model, task.physics, task.act_dim))
    if size != DEFAULT:
        return None, (f"{name}: its model is over the env-step kernel's caps "
                      f"(task_step_kernel's {KERNEL_SUFFIX[size][1:]} build runs it)")
    aux_keys, out_aux, comp_keys = _probe_keys(task)
    if out_aux != aux_keys:
        return None, f"{name}: output aux keys {out_aux} differ from the reset's {aux_keys}"
    if aux_keys != tuple(sorted(kind[1])) or comp_keys != tuple(sorted(kind[2])):
        return None, (f"{name}: keys {aux_keys}, {comp_keys} differ from the kernel's "
                      f"{kind[1]}, {kind[2]}")
    return (kind[0], aux_keys, comp_keys), ""


def env_kernel_supports(task) -> bool:
    """Whether `env_step_kernel` implements `task` (`_kernel_match`); any
    other task's env step is `task_step_kernel` (`ops.task_kernel`)."""
    return _kernel_match(task)[0] is not None


def pack_tables(task, frame_skip: Optional[int] = None):
    """All tables of the env-step kernel for `task` (physics + task
    constants). Raises for a task the kernel does not implement: any class
    but those of TASK_KINDS (subclasses, other pre-physics hooks included)."""
    match, why = _kernel_match(task)
    if match is None:
        raise NotImplementedError(why)
    return _pack_tables(task, match, frame_skip)


def _pack_tables(task, match, frame_skip):
    t = pack_physics(task.model, task.physics, frame_skip, act=task.act_dim,
                     naux=len(match[1]), obs_dim=task.obs_dim)
    _, caps = tables_type()
    t.task_kind, aux_keys, comp_keys = match
    t.naux, t.ncomp = len(aux_keys), len(comp_keys)
    for k in AUX_KEYS:
        setattr(t, "ax_" + k, aux_keys.index(k) if k in aux_keys else -1)
    for k in COMP_KEYS:
        setattr(t, "cp_" + k, comp_keys.index(k) if k in comp_keys else -1)
    t.act = task.act_dim
    t.obs_dim = t.obs_live = task.obs_dim
    t.max_steps = int(task.max_episode_steps)
    for r in range(t.nr):
        t.row_foot[r] = -1
    if t.task_kind <= 2:
        _pack_walker(t, task, caps)
    elif t.task_kind == 3:
        _pack_reacher(t, task)
    elif t.task_kind <= 6:
        _pack_arm(t, task)
    elif t.task_kind <= 8:
        _pack_pendulum(t, task)
    else:
        _pack_mujoco(t, task)
    scratch_layout(t)  # again, with the task's obs and aux
    return t


def _draws(t, entries):
    """q draws (q address, stream, base, lo, hi): q[adr] = base + U[lo, hi)."""
    _, caps = tables_type()
    if len(entries) > caps["MAX_DRAWS"]:
        raise ValueError(f"{len(entries)} reset draws exceed the kernel cap")
    t.nqdraw = len(entries)
    for k, (adr, stream, base, lo, hi) in enumerate(entries):
        t.qdraw_adr[k], t.qdraw_stream[k] = adr, stream
        t.qdraw_base[k], t.qdraw_lo[k], t.qdraw_span[k] = _f32(base), _f32(lo), _f32(hi - lo)


def _frames(t, frames):
    t.nparts = len(frames)
    for k, (host, pos) in enumerate(frames):
        t.part_host[k] = int(host)
        for j in range(3):
            t.part_pos[3 * k + j] = _f32(float(pos[j]))


def _actuated(t, dofs, qadrs, gains):
    for k, (d, qa, g) in enumerate(zip(dofs, qadrs, gains)):
        t.act_dof[k], t.act_qadr[k], t.gain[k] = int(d), int(qa), _f32(g)


def _pack_walker(t, task, caps):
    """WalkerTask and the Flagrun tasks (locomotion.py)."""
    from pybulletgym_tpu_torch.envs import locomotion as loco

    mode = task.spec.alive_mode
    if mode not in ALIVE_MODES:
        raise NotImplementedError(f"alive mode {mode!r} is not in the CUDA kernels yet")
    if mode == "cheetah" and len(task.foot_rows) < 6:
        raise ValueError("the cheetah alive mode reads feet 1, 2, 4 and 5")
    t.alive_mode = ALIVE_MODES[mode]
    t.nfeet = len(task.foot_rows)
    t.base_body = int(task.base_body)
    if t.nfeet > caps["MAX_FEET"] or len(task.part_frames) > caps["MAX_PARTS"]:
        raise ValueError(f"{task.spec.name}: feet/parts exceed the kernel caps")
    _actuated(t, task.act_dofs, task.act_qadr, task.gains[:, 0])
    for k in range(task.act_dim):
        t.j_mid[k] = _f32(task.j_mid[k, 0])
        t.j_half[k] = _f32(task.j_halfrange[k, 0])
    _frames(t, [(host, pos) for host, pos, _quat in task.part_frames])
    # row -> foot table (a row's primary geom is at most one foot's)
    for f, rows in enumerate(task.foot_rows):
        for r in rows:
            if t.row_foot[r] != -1:
                raise ValueError(f"contact row {r} belongs to feet {t.row_foot[r]} and {f}")
            t.row_foot[r] = f
    # reset draws: uniform(-0.1, 0.1) per actuated joint, on stream k
    m = task.model
    _draws(t, [(int(qa), k, float(m.qpos0[qa]), -0.1, 0.1) for k, qa in enumerate(task.act_qadr)])
    t.target_x = _f32(task.walk_target[0])
    t.target_y = _f32(task.walk_target[1])
    t.control_dt = _f32(task.physics.control_dt)
    stall_scale = task.spec.cost_scale if task.spec.stall_scale is None else task.spec.stall_scale
    t.elec_coef = _f32(task.spec.cost_scale * loco.WalkerTask.electricity_cost)
    t.stall_coef = _f32(stall_scale * loco.WalkerTask.stall_torque_cost)
    t.limit_coef = _f32(loco.WalkerTask.joints_at_limit_cost)
    t.n_act = _f32(float(task.act_dim))
    t.initial_z = _f32(task.initial_z)
    if t.task_kind >= 1:  # HumanoidFlagrunTask: flags U[-x, x) x U[-y, y)
        t.flag_streams[0], t.flag_streams[1] = loco.FLAG_STREAM, loco.FLAG_STREAM + 1
        t.flag_lo_x, t.flag_span_x = _f32(-loco.FLAG_X), _f32(loco.FLAG_X - (-loco.FLAG_X))
        t.flag_lo_y, t.flag_span_y = _f32(-loco.FLAG_Y), _f32(loco.FLAG_Y - (-loco.FLAG_Y))
        t.flag_timeout = _f32(loco.FLAG_TIMEOUT)
    if t.task_kind == 2:  # HumanoidFlagrunHarderTask
        _pack_harder(t, task)


def _pack_reacher(t, task):
    """ReacherTask (manipulation.py): the central and elbow joints are act
    slots 0 and 1, the target's slides jq 0 and 1."""
    _actuated(t, (task.central_dof, task.elbow_dof), (task.central_qadr, task.elbow_qadr),
              (task.torque_gain, task.torque_gain))
    t.j_mid[1], t.j_half[1] = _f32(task.elbow_mid), _f32(task.elbow_halfrange)
    t.jq[0], t.jq[1] = task.tx_qadr, task.ty_qadr
    _frames(t, [task.fingertip, task.target_frame])
    lim = task.TARG_LIMIT
    _draws(t, [(task.central_qadr, 0, 0.0, -3.14, 3.14), (task.elbow_qadr, 1, 0.0, -3.14, 3.14),
               (task.tx_qadr, 2, 0.0, -lim, lim), (task.ty_qadr, 3, 0.0, -lim, lim)])


def _pack_arm(t, task):
    """Pusher, Striker, Thrower (manipulation.py): the arm's joints, the
    tips/object/goal frames, the velocity draws on streams 10 + dof (none
    for the object's and goal's slides, which the task zeroes), and each
    task's placement of the object and goal."""
    from pybulletgym_tpu_torch.envs.locomotion import _qadr

    m = task.model
    _actuated(t, task.arm_dofs, task.arm_qadr, task.gains)
    _frames(t, [task.tips[:2], task.obj_frame[:2], task.goal_frame[:2]])
    if t.task_kind == 6:  # Thrower: the goal's slides ~ U(-0.3, 0.3) on streams 0, 1
        still = (task.goal_x, task.goal_y)
        _draws(t, [(_qadr(m, d), k, 0.0, -0.3, 0.3) for k, d in enumerate(still)])
    else:
        still = task._still()
        t.push_stream[0], t.push_stream[1] = 0, 1
        if t.task_kind == 4:  # Pusher: the object, out from the goal at the origin
            t.qpos0[_qadr(m, task.goal_x)] = t.qpos0[_qadr(m, task.goal_y)] = 0.0
            into, box, base = (task.obj_x, task.obj_y), ((-0.3, 0.0), (-0.2, 0.2)), (0.0, 0.0)
            centre = (0.0, 0.0)
        else:  # Striker: the ball fixed, the goal out from it
            bx, by = task.BALL_WORLD
            t.qpos0[_qadr(m, task.obj_x)] = _f32(by - task._obj_base[1])
            t.qpos0[_qadr(m, task.obj_y)] = _f32(bx - task._obj_base[0])
            # x lands in the goal's second slide, y in its first (document order)
            into, box = (task.goal_y, task.goal_x), ((0.15, 0.7), (0.1, 1.0))
            base, centre = task._goal_base, (bx, by)
        for j in range(2):
            t.push_qadr[j] = _qadr(m, into[j])
            t.push_lo[j], t.push_span[j] = _f32(box[j][0]), _f32(box[j][1] - box[j][0])
            t.push_centre[j], t.push_base[j] = _f32(centre[j]), _f32(base[j])
    vdofs = [d for d in range(m.nv) if d not in still]
    _, caps = tables_type()
    if len(vdofs) > caps["MAX_DRAWS"]:
        raise ValueError(f"{len(vdofs)} velocity draws exceed the kernel cap")
    t.nvdraw = len(vdofs)
    for k, d in enumerate(vdofs):
        t.vdraw_dof[k], t.vdraw_stream[k] = d, 10 + d
    t.vdraw_lo, t.vdraw_span = _f32(-0.005), _f32(0.005 - (-0.005))


def _pack_pendulum(t, task):
    """The pendula (pendula.py): the slider is act slot 0, the hinges jq/jv
    0 and 1; the double pendulum reads pole2's COM (base_body)."""
    _actuated(t, (task.slider_dof,), (task.slider_qadr,), (task.torque_gain,))
    if t.task_kind == 7:
        t.swingup = int(task.swingup)
        t.jq[0], t.jv[0] = task.hinge_qadr, task.hinge_dof
        _draws(t, [(task.hinge_qadr, 0, np.pi if task.swingup else 0.0, -0.1, 0.1)])
    else:
        t.jq[0], t.jv[0] = task.j1_qadr, task.j1_dof
        t.jq[1], t.jv[1] = task.j2_qadr, task.j2_dof
        t.base_body = task.pole2
        _draws(t, [(task.j1_qadr, 0, 0.0, -0.1, 0.1), (task.j2_qadr, 1, 0.0, -0.1, 0.1)])


# mujoco_family.py's termination rules, as engine_core.h codes them (MJ_DONE_*)
MJ_DONE = {"HopperMuJoCoTask": 1, "Walker2DMuJoCoTask": 2, "HalfCheetahMuJoCoTask": 0,
           "AntMuJoCoTask": 3, "HumanoidMuJoCoTask": 4}


def _pack_mujoco(t, task):
    """The Gym-MuJoCo mirrors (mujoco_family.py). Reset: q = qpos0 + U(±noise)
    on stream i and v = U(±noise) on stream nq + i (Reacher: the joints
    U(±0.1) on streams 0, 1, the target in a disk on streams 2, 3, the arm's
    velocities U(±0.005) on streams 4 + dof); the walkers' constants."""
    from pybulletgym_tpu_torch.envs import mujoco_family as mjf

    m = task.model
    _actuated(t, task.act_dofs, [0] * task.act_dim, task.torque_gain)
    _, caps = tables_type()
    if t.task_kind == 10:  # ReacherMuJoCoTask: q, v indexed by dof, as there
        t.jq[0], t.jq[1], t.jq[2], t.jq[3] = task.j0, task.j1, task.tx, task.ty
        t.jv[0], t.jv[1] = task.j0, task.j1
        _frames(t, [task.fingertip[:2], task.target[:2]])
        _draws(t, [(task.j0, 0, 0.0, -0.1, 0.1), (task.j1, 1, 0.0, -0.1, 0.1)])
        t.disk_streams[0], t.disk_streams[1] = 2, 3
        t.disk_r = _f32(0.2)
        t.disk_ang_lo, t.disk_ang_span = _f32(-3.14159), _f32(3.14159 - (-3.14159))
        vdraws = [(d, 4 + d) for d in range(m.nv) if d not in (task.tx, task.ty)]
        noise = 0.005
    else:
        noise = task.reset_noise
        _draws(t, [(j, j, float(m.qpos0[j]), -noise, noise) for j in range(m.nq)])
        vdraws = [(d, m.nq + d) for d in range(m.nv)]
    if len(vdraws) > caps["MAX_DRAWS"]:
        raise ValueError(f"{len(vdraws)} velocity draws exceed the kernel cap")
    t.nvdraw = len(vdraws)
    for k, (d, stream) in enumerate(vdraws):
        t.vdraw_dof[k], t.vdraw_stream[k] = d, stream
    t.vdraw_lo, t.vdraw_span = _f32(-noise), _f32(noise - (-noise))
    if t.task_kind == 12:  # the double pendulum's tip
        _frames(t, [(task.pole2, task.TIP)])
    if t.task_kind != 9:
        return
    name = type(task).__name__
    t.control_dt = _f32(task.physics.control_dt)
    t.mj_done = MJ_DONE[name]
    t.mj_free = int(isinstance(task, mjf._MjFreeWalker))
    if t.mj_free:
        root = m.bodies[0]
        if root.jtype != JointType.FREE or root.q_adr != 0 or root.v_adr != 0:
            raise NotImplementedError(f"{name}: the obs read the root free joint at q[0:7]")
        t.mj_fwd = _f32(task.fwd_coef)
        t.obs_live = task.obs_dim - task.n_zero
    else:
        t.mj_clip_qvel = int(task.clip_qvel)
        t.mj_fwd = 1.0
    t.mj_alive, t.mj_ctrl = _f32(task.alive_bonus), _f32(task.ctrl_coef)


def _pack_harder(t, task):
    """FlagrunHarder's constants: initial_z pinned to 0.8, the lying reset,
    the cube throw and the get-up limit (locomotion.py)."""
    m = task.model
    root = m.bodies[task.base_body]
    if task.base_body != 0 or root.jtype != JointType.FREE or root.q_adr != 0 or root.v_adr != 0:
        raise NotImplementedError("the cube throw reads the root free joint at q[0:7], v[0:6]")
    t.initial_z = _f32(0.8)
    t.lie_streams[0], t.lie_streams[1] = task.LIE_STREAMS
    t.root_qadr = root.q_adr
    t.lie_z = _f32(0.3)
    t.lie_c = _f32(float(np.cos(np.pi / 4.0)))
    for j, stream in enumerate(task.CUBE_STREAMS):
        t.cube_streams[j] = stream
    t.cube_qadr, t.cube_vadr = task.cube_qadr, task.cube_vadr
    t.cube_period = _f32(task.CUBE_PERIOD)
    t.cube_min_frame = _f32(task.CUBE_MIN_FRAME)
    t.cube_from_dist = _f32(task.CUBE_FROM_DIST)
    t.angle_lo, t.angle_span = _f32(-3.14), _f32(3.14 - (-3.14))
    t.speed_lo, t.speed_span = _f32(20.0), _f32(30.0 - 20.0)
    t.jitter_lo, t.jitter_span = _f32(-1.0), _f32(1.0 - (-1.0))
    t.ground_limit = _f32(task.GROUND_LIMIT)


def _probe_keys(task) -> Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]:
    """The kernel writes aux and reward components in sorted key order;
    probe the task's hooks once on one env for its keys. Returns the sorted
    (reset aux keys, output aux keys, reward keys)."""
    one = torch.zeros((1,), dtype=torch.uint32)
    ids = (one, torch.zeros((1,), dtype=torch.int32), one)
    q, v, aux = task.initial_state_scalar(*ids)
    z = torch.zeros((1,))
    n_rows = len(sc_rows(ct.build_contact_plan(task.model, task.physics.solver)))
    _, _, _, aux2, comps = task.output_scalar(
        list(q), list(v), [z] * n_rows, [z] * task.act_dim, aux, ids
    )
    return tuple(sorted(aux)), tuple(sorted(aux2)), tuple(sorted(comps))


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _sources(names):
    h = hashlib.sha256()
    for n in names:
        with open(os.path.join(CSRC, n), "rb") as f:
            h.update(n.encode() + b"\0" + f.read())
    return h


class Builds:
    """Compile each (cmd_prefix, src, out_name, flags) job into
    BUILD_DIR/out_name unless it is there: the compilers are all started
    here, at once, and run beside the caller until `wait()`, which returns
    {path: compiler output}; `stop()` kills any still running (`wait` does
    on a failure). Builds into a temp file, then renames it into place, so
    concurrent processes never load a half-written library."""

    def __init__(self, jobs):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.out, self.running = {}, []
        try:
            for cmd_prefix, src, out_name, flags in jobs:
                so = os.path.join(BUILD_DIR, out_name)
                if os.path.exists(so):
                    log = so + ".log"
                    self.out[so] = open(log).read() if os.path.exists(log) else ""
                    continue
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = (list(cmd_prefix) + list(flags)
                       + ["-I", CSRC, "-o", tmp, os.path.join(CSRC, src)])
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                self.running.append((proc, cmd, so, tmp))
        except BaseException:
            self.stop()
            raise

    def wait(self) -> Dict[str, str]:
        try:
            for proc, cmd, so, tmp in self.running:
                text = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"building failed ({' '.join(cmd)}):\n{text}")
                with open(so + ".log", "w") as f:
                    f.write(text)
                os.replace(tmp, so)
                self.out[so] = text
        finally:
            self.stop()
        return self.out

    def stop(self):
        for proc, _, _, tmp in self.running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def _compile(jobs) -> Dict[str, str]:
    """Build the jobs (`Builds`), all at once in parallel, and wait for
    them; returns {path: compiler output}."""
    return Builds(jobs).wait()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _check_layout(lib, size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None):
    Tables, _ = tables_type(size, caps)
    lib.eng_tables_bytes.restype = ctypes.c_int
    lib.eng_tables_layout.restype = ctypes.c_int
    lib.eng_tables_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n = len(Tables._fields_)
    offs = (ctypes.c_int32 * n)()
    got = lib.eng_tables_layout(ctypes.addressof(offs), n)
    want = [getattr(Tables, name).offset for name, _ in Tables._fields_]
    if lib.eng_tables_bytes() != ctypes.sizeof(Tables) or got != n or list(offs) != want:
        raise RuntimeError("Tables layout of the built library differs from engine_core.h's parse")


_P = ctypes.c_void_p
_ENV_ARGS = [_P] * 21 + [ctypes.c_int]


def _engine_jobs(size: int, caps: Optional[Tuple[int, ...]] = None):
    """The nvcc jobs of engine.cu, one per group width, for the size class
    `size` (and the sized class's `caps`; its flags in the content hash), and
    their libraries' names: {G: name}."""
    flags = NVCC_FLAGS + class_flags(size, caps)
    h = _sources(["engine_core.h", "engine.cu"])
    h.update(" ".join(flags).encode())
    names = {G: f"libengine_cuda{_LIB_SUFFIX[size]}_g{G}_{h.hexdigest()[:16]}.so"
             for G in LANE_WIDTHS}
    return [([nvcc_path()], "engine.cu", names[G], flags + (f"-DENG_LANES={G}",))
            for G in LANE_WIDTHS], names


def _extra_args(size: int) -> int:
    """The pointers a launcher of the size class takes after the host
    tables: the tables' device copy and the scratch buffer (large, huge and
    sized)."""
    return 0 if size == DEFAULT else 2


def load_cuda_library(size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None):
    """Build (once per source hash, one nvcc per group width, all started
    together) and load the CUDA libraries of the size class `size`
    (DEFAULT, LARGE or True, HUGE, or SIZED with its `caps`). Returns ({G:
    ctypes library}, nvcc output including -Xptxas -v, one section per G)."""
    return _load_cuda_library(int(size), None if caps is None else tuple(caps))


@functools.lru_cache(maxsize=None)
def _load_cuda_library(size: int, caps: Optional[Tuple[int, ...]]):
    jobs, names = _engine_jobs(size, caps)
    built = _compile(jobs)
    libs, logs = {}, []
    for G in LANE_WIDTHS:
        so = os.path.join(BUILD_DIR, names[G])
        lib = ctypes.CDLL(so)
        _check_layout(lib, size, caps)
        lib.eng_lanes.restype = ctypes.c_int
        if lib.eng_lanes() != G:
            raise RuntimeError(f"{so} is built for {lib.eng_lanes()} lanes, not {G}")
        lib.eng_launch_config.argtypes = [ctypes.c_int, ctypes.c_int, _P]
        lib.eng_launch_config.restype = ctypes.c_int
        # the large, huge and sized builds take the tables' device copy and
        # their buffer after the host copy, and have no env_step_kernel
        lib.launch_physics_step.argtypes = ([_P] * (7 + _extra_args(size)) + [ctypes.c_int] * 2
                                            + [_P])
        lib.launch_physics_step.restype = ctypes.c_int
        if size == DEFAULT:
            lib.launch_env_step.argtypes = _ENV_ARGS + [ctypes.c_int, _P]
            lib.launch_env_step.restype = ctypes.c_int
        libs[G] = lib
        logs.append(f"== G={G}\n{built[so]}")
    return libs, "\n".join(logs)


KERNELS = ("physics_step_kernel", "env_step_kernel")  # eng_launch_config's kernel index


@functools.lru_cache(maxsize=None)
def _launch_config(lanes: int, kernel: int, stride: int, device: int,
                   size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None) -> Dict[str, int]:
    libs, _ = load_cuda_library(size, caps)
    out = (ctypes.c_int32 * 5)()
    with torch.cuda.device(device):
        rc = libs[lanes].eng_launch_config(kernel, stride, _P(ctypes.addressof(out)))
    if rc != 0:
        raise RuntimeError(f"{KERNELS[kernel]}: no launch configuration for G={lanes} and a "
                           f"{stride * 4}-byte env scratch (CUDA error {rc})")
    E, per_sm, smem, regs, local = list(out)
    return {"G": lanes, "E": E, "threads": E * lanes, "blocks_per_sm": per_sm,
            "envs_per_sm": per_sm * E, "shared_bytes": smem, "env_scratch_bytes": stride * 4,
            "registers": regs, "local_bytes": local}


def launch_config(tables, kernel: str, B: Optional[int] = None, device: int = 0) -> Dict[str, int]:
    """The launch of `kernel` for `tables` on the card: the group width G,
    the envs a block E, threads and dynamic shared bytes a block, resident
    blocks (and envs) per SM from the occupancy API, the kernel's
    registers and local bytes a thread, and for a batch B the blocks. The
    shared bytes are those of the scratch, none in the large, huge and sized
    classes (`buffer_bytes`: one env's slice of their device buffer).
    Raises for
    tables with more dofs than the library of their G holds, and for
    env_step_kernel on the large, huge and sized classes' tables."""
    size, caps = tables_class(tables), tables_caps(tables)
    if tables.nv > lane_nv(tables.lanes, size, caps):
        raise ValueError(f"{tables.nv} dofs exceed the {lane_nv(tables.lanes, size, caps)} that "
                         f"the library of G={tables.lanes} lanes holds")
    if size != DEFAULT and kernel != "physics_step_kernel":
        raise ValueError(f"{kernel} has no build for the {KERNEL_SUFFIX[size][1:]} class's tables")
    cfg = dict(_launch_config(tables.lanes, KERNELS.index(kernel), tables.sc_stride, device,
                              size, caps), buffer_bytes=4 * buffer_floats(tables))
    if B is not None:
        cfg["blocks"] = -(-B // cfg["E"])
    return cfg


# ---------------------------------------------------------------------------
# argument checks and pointers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _env_tensors(task, tables, state, action):
    """Check an env step's inputs; returns (inputs, outputs) tensor lists in
    the launchers' argument order, outputs freshly allocated. The aux rows
    are the state's keys in sorted order, as many as the tables say (none:
    a (0, B) tensor, which the kernel never reads)."""
    m = task.model
    B = state.q.shape[-1]
    dev = state.q.device
    f32, b8 = torch.float32, torch.bool
    keys = sorted(state.aux)
    if len(keys) != tables.naux or len(state.rewards) != tables.ncomp:
        raise ValueError(f"aux keys {keys}, reward keys {sorted(state.rewards)}: the kernel's "
                         f"tables have {tables.naux} and {tables.ncomp}")
    aux = torch.stack([state.aux[k] for k in keys], 0) if keys else state.q.new_empty((0, B))
    ins = [
        (state.q, "q", f32, (m.nq, B)), (state.v, "v", f32, (m.nv, B)),
        (action, "action", f32, (task.act_dim, B)), (aux, "aux", f32, (len(keys), B)),
        (state.terminated, "terminated", b8, (B,)), (state.truncated, "truncated", b8, (B,)),
        (state.step_count, "step_count", torch.int32, (B,)),
        (state.epoch, "epoch", torch.uint32, (B,)), (state.seed, "seed", torch.uint32, (B,)),
        (state.env_id, "env_id", torch.int32, (B,)),
    ]
    for x, name, dt, shape in ins:
        _check(x, name, dt, shape, dev)
    e = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    outs = [
        e(m.nq, B), e(m.nv, B), e(task.obs_dim, B), e(B), e(B, dtype=b8), e(B, dtype=b8),
        e(B, dtype=torch.int32), e(B, dtype=torch.uint32), e(len(keys), B), e(tables.ncomp, B),
    ]
    return [x for x, *_ in ins], outs


def _env_state(state, outs):
    from pybulletgym_tpu_torch.envs.base import EnvState

    q2, v2, obs, rew, term, trunc, sc, ep, aux, comps = outs
    return EnvState(
        q=q2, v=v2, obs=obs, reward=rew, terminated=term, truncated=trunc,
        step_count=sc, epoch=ep, env_id=state.env_id, seed=state.seed,
        aux={k: aux[j] for j, k in enumerate(sorted(state.aux))},
        rewards={k: comps[j] for j, k in enumerate(sorted(state.rewards))},
    )


def _ptrs(tensors):
    return [_P(x.data_ptr()) for x in tensors]


def _launch_checked(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _tables_args(tables, uploaded: Dict[int, torch.Tensor], device: torch.device):
    """The launchers' leading arguments for `tables`: the host copy and, for
    the large, huge and sized classes, the device copy that their kernels read,
    uploaded to `device` at the first call and kept in `uploaded` (by device
    index). The wrappers call this before a CUDA graph captures a launch."""
    args = [_P(ctypes.addressof(tables))]
    if tables_class(tables) != DEFAULT:
        key = device.index or 0
        if key not in uploaded:
            host = torch.frombuffer(bytearray(bytes(tables)), dtype=torch.uint8)
            uploaded[key] = host.to(device)
        args.append(_P(uploaded[key].data_ptr()))
    return args


def _buffer_args(tables, buffers: Dict[tuple, torch.Tensor], device: torch.device, B: int):
    """The device buffer argument for a launch of B envs on `device`: the
    large, huge and sized classes' whole scratch (none in the default one): B
    slices of `buffer_floats(tables)` floats, allocated at the first call
    for each (device, B) and kept in `buffers`, so that a CUDA graph replays
    its launch on the buffer it captured. Raises if a capture would allocate
    it (the wrappers' `prepare(device, B)` does that before any capture),
    and if it does not fit the card, naming B and the bytes an env: nothing
    falls back."""
    n = buffer_floats(tables)
    if n == 0:
        return []
    key = (device.index or 0, int(B))
    if key not in buffers:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the scratch buffer of B={B} envs is not allocated: call "
                               "prepare(device, B) before capturing a CUDA graph")
        try:
            buffers[key] = torch.empty((int(B), n), dtype=torch.float32, device=device)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"the scratch buffer of B={B} envs ({4 * n} bytes an env, "
                               f"{4 * n * B} in all) does not fit {device}: {e}") from None
    return [_P(buffers[key].data_ptr())]


# Launches of each kernel by every wrapper instance since the last reset;
# each wrapper also keeps its own `launches`. A launch recorded into a CUDA
# graph counts in CAPTURED instead, and in LAUNCHES each time the graph's
# owner replays it (`envs.base._StepGraph`). The large, huge and sized
# classes' builds count apart, as *_large, *_huge and *_sized.
LAUNCHES: Dict[str, int] = {"physics_step_kernel": 0, "env_step_kernel": 0,
                            "task_step_kernel": 0, "physics_step_kernel_large": 0,
                            "task_step_kernel_large": 0, "physics_step_kernel_huge": 0,
                            "task_step_kernel_huge": 0, "physics_step_kernel_sized": 0,
                            "task_step_kernel_sized": 0}
CAPTURED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(kernel: str, wrapper) -> None:
    """Count one launch of `kernel` by `wrapper` (or its recording, while
    the current stream captures a CUDA graph)."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[kernel] += 1
    else:
        wrapper.launches += 1
        LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


class CudaPhysicsStep:
    """step(q (nq,B), v (nv,B), tau (nv,B)) -> (q', v', depths (R,B)).

    CUDA tensors launch `physics_step_kernel` (its large, huge or sized
    build for a model over the default, large or huge caps, the tables
    uploaded to the card once; the large, huge and sized builds' scratch
    buffer allocated once for each batch size); CPU tensors
    run `make_physics_step_plain`. `launches` counts kernel launches (a
    launch recorded into a CUDA graph: at each replay, `count_launch`). One
    step at a time: the buffer of a batch size is shared by its launches."""

    def __init__(self, model: Model, cfg: PhysicsConfig):
        self.model, self.cfg = model, cfg
        self.plain, self.plan, self.n_rows = make_physics_step_plain(model, cfg)
        self.tables = pack_physics(model, cfg)
        self.size, self.caps = tables_class(self.tables), tables_caps(self.tables)
        self.kernel = "physics_step_kernel" + KERNEL_SUFFIX[self.size]
        self.device_tables: Dict[int, torch.Tensor] = {}
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.launches = 0

    def prepare(self, device: torch.device, B: Optional[int] = None):
        """Build the library, pick the launch configuration on `device` (the
        occupancy API, cudaFuncSetAttribute), upload the large, huge and
        sized classes' tables and, for a batch of B envs, allocate their
        scratch buffer: ahead of a graph capture, which
        these calls would break."""
        launch_config(self.tables, "physics_step_kernel", device=device.index or 0)
        _tables_args(self.tables, self.device_tables, device)
        if B is not None:
            _buffer_args(self.tables, self.buffers, device, B)

    def __call__(self, q, v, tau):
        if q.device.type == "cpu":
            return self.plain(q, v, tau)
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        m, dev, B = self.model, q.device, q.shape[-1]
        _check(q, "q", torch.float32, (m.nq, B), dev)
        _check(v, "v", torch.float32, (m.nv, B), dev)
        _check(tau, "tau", torch.float32, (m.nv, B), dev)
        libs, _ = load_cuda_library(self.size, self.caps)
        E = launch_config(self.tables, "physics_step_kernel", device=dev.index or 0)["E"]
        outs = [torch.empty((m.nq, B), device=dev), torch.empty((m.nv, B), device=dev),
                torch.empty((self.n_rows, B), device=dev)]
        with torch.cuda.device(dev):
            rc = libs[self.tables.lanes].launch_physics_step(
                *_tables_args(self.tables, self.device_tables, dev),
                *_buffer_args(self.tables, self.buffers, dev, B),
                *_ptrs([q, v, tau] + outs), B, E, _P(torch.cuda.current_stream(dev).cuda_stream),
            )
        _launch_checked(rc, self.kernel)
        count_launch(self.kernel, self)
        return tuple(outs)


class CudaEnvStep:
    """step(state: EnvState, action (act, B)) -> EnvState.

    CUDA tensors launch `env_step_kernel`; CPU tensors run
    `envs.base.env_step_plain`. `launches` counts kernel launches (none
    while a CUDA graph is captured)."""

    backend = "fused"
    kernel = "env_step_kernel"

    def __init__(self, task, frame_skip: Optional[int] = None, tables=None):
        self.task = task
        self.frame_skip = frame_skip
        self.tables = pack_tables(task, frame_skip) if tables is None else tables
        self.launches = 0

    def __call__(self, state, action):
        from pybulletgym_tpu_torch.envs.base import env_step_plain

        dev = state.q.device
        if dev.type == "cpu":
            return env_step_plain(self.task, state, action, self.frame_skip)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        ins, outs = _env_tensors(self.task, self.tables, state, action)
        libs, _ = load_cuda_library()
        E = launch_config(self.tables, "env_step_kernel", device=dev.index or 0)["E"]
        B = state.q.shape[-1]
        with torch.cuda.device(dev):
            rc = libs[self.tables.lanes].launch_env_step(
                _P(ctypes.addressof(self.tables)), *_ptrs(ins + outs), B, E,
                _P(torch.cuda.current_stream(dev).cuda_stream),
            )
        _launch_checked(rc, "env_step_kernel")
        count_launch("env_step_kernel", self)
        return _env_state(state, outs)


def make_cuda_physics_step(model: Model, cfg: PhysicsConfig):
    """(step, plan, n_rows), like `ops.step.make_physics_step_plain`."""
    step = CudaPhysicsStep(model, cfg)
    return step, step.plan, step.n_rows


def make_cuda_env_step(task, frame_skip: Optional[int] = None):
    """The one-launch env-step wrapper for `task`: `CudaEnvStep`
    (`env_step_kernel`) for the task classes it implements, else
    `ops.task_kernel.CudaTaskStep` (`task_step_kernel`, the task's hooks
    translated into the kernel). `frame_skip` overrides the task's number
    of physics substeps (0 returns the post-reset state)."""
    match, _ = _kernel_match(task)
    if match is None:
        from pybulletgym_tpu_torch.ops.task_kernel import CudaTaskStep

        return CudaTaskStep(task, frame_skip)
    return CudaEnvStep(task, frame_skip, _pack_tables(task, match, frame_skip))


# ---------------------------------------------------------------------------
# work per env step, for the kernels' bound
# ---------------------------------------------------------------------------

# float operations of engine_core.h's primitives (a product or a sum is
# one; sqrt, division, sin and cos count one each, so this is a floor)
_V_ADD, _V_DOT, _V_CROSS, _M3_VEC, _M3_MUL = 3, 5, 9, 15, 45
_SV_ADD, _SV_DOT, _SV_CROSS = 6, 10, 30
_INERTIA_MUL = 42
_RODRIGUES, _M3_FROM_QUAT, _ATAN2 = 42, 24, 17
_QUAT_INTEGRATE = 59
# one capsule/sphere pair (engine_core.h · pair_contact): four segment ends,
# the closest points (less the branch that only parallel capsules skip), the
# normal, depth, midpoint and tangent basis
_PAIR_CONTACT = 194
# a disk row's rim offset (engine_core.h · disk_rim): the axis, n x w, its
# norm, e1 (or R's column), the scaled offset and its sum; an e2 row also
# takes w x e1
_DISK_RIM = _M3_VEC + _V_CROSS + _V_DOT + 3 + 3 + 3 + _V_ADD


def _fk_flops(t, inert: bool) -> int:
    n = 0
    for i in range(t.nb):
        jt = t.jtype[i]
        if jt == int(JointType.FREE):
            n += _M3_FROM_QUAT + 3 * _V_CROSS + 6 * 2 * _SV_ADD
        else:
            n += _M3_MUL + _M3_VEC + _V_ADD + 2 * _SV_ADD  # R0, p0, velocity
            if jt == int(JointType.HINGE):
                n += 1 + 2 * (_M3_VEC + _V_ADD) + _RODRIGUES + _M3_MUL + _M3_VEC + 6 + _V_CROSS - _V_ADD
            else:
                n += _M3_VEC + 7
        if t.has_mass[i]:
            n += _M3_VEC + _V_ADD + (2 * _M3_MUL + _V_DOT + 3 + 36 if inert else 0)
    return n


def _chol_flops(n: int) -> Tuple[int, int]:
    """(factorisation, one forward or back substitution)"""
    fact = sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    return fact, sum(2 * i + 1 for i in range(n))


def limit_pairs(t) -> list:
    """Each limit row's place in the default class's sweep, as the kernels
    read it from the tables (t.lim_first, engine_core.h · limit_raw): 1 for
    the second row of a pair (solved, set up and swept with the row before,
    whose Y row it shares), else 0."""
    firsts = set(t.lim_first[:t.lim_steps])
    return [int(m not in firsts) for m in range(t.nl)]


def sweep_group_sums(t) -> int:
    """The dependent group sums (butterflies) of one PGS sweep for the
    tables `t`: one a contact row and one a limit row or limit pair
    (engine_core.h · contact_step, limit_step; in the global classes
    win_step, however many windows a row spans)."""
    return t.nr + t.lim_steps


def _path_flops(t) -> Tuple[int, int, int, int, list, list, list, int]:
    """The default class's loops over root paths (engine_core.h · ltl_factor,
    ltl_solve, z's loop, path_solve_t): (factorization, the dynamics' L^-T
    solve that rides on it, a back substitution L^-1 z, z = L v + dt y, each
    contact row's support size, each row's forward solve, each limit row's
    support size, the limit rows' solves: a pair's one row solved once). A
    solved entry at depth k costs one product and k products and sums (the
    dynamics' k more products: L(k, i) from H(k, i))."""
    nv, nfloor = t.nv, t.nr - t.npair
    depth = [t.dof_depth[d] for d in range(nv)]
    fact = sum(3 + sum(1 + 2 * (m + 1) for m in range(k)) + k for k in depth)
    solve = sum(1 + 3 * k for k in depth)
    z_flops = sum(2 * (k + 1) + 2 for k in depth)
    masks = [root_path(t, t.row_body[r]) for r in range(nfloor)]
    masks += [root_path(t, t.pair_a[k]) | root_path(t, t.pair_b[k]) for k in range(t.npair)]
    rows_len = [bin(m).count("1") for m in masks]
    rows_solve = [sum(1 + 2 * depth[d] for d in range(nv) if m >> d & 1) for m in masks]
    lim_len = [depth[t.lim_dof[m]] + 1 for m in range(t.nl)]
    lim_solve = sum(n * n for n, second in zip(lim_len, limit_pairs(t)) if not second)
    return fact, solve, solve, z_flops, rows_len, rows_solve, lim_len, lim_solve


def substep_flops(t, dense: bool = False) -> int:
    """Float operations of one `substep` of engine_core.h for the tables
    `t`, counted from its loop bounds: over the dof tree's root paths
    (`_path_flops`; the sweep's Gram entries at set-up, a limit pair's one
    solve, set-up and step). `dense`: the dense Cholesky, rows over every
    dof and per-direction sweep that the default class ran before its root
    paths, and the large, huge and sized classes before their tree blocks
    (the work the plain version does)."""
    nb, nv, nr, nl = t.nb, t.nv, t.nr, t.nl
    fact, solve = _chol_flops(nv)
    back = z_flops = solve
    if not dense:
        fact, solve, back, z_flops, rows_len, rows_solve, lim_len, lim_solve = _path_flops(t)
    else:
        rows_len, rows_solve, lim_len, lim_solve = [nv] * nr, [solve] * nr, [nv] * nl, nl * solve
        z_flops = sum(1 + 2 * (nv - 1 - i) + 2 for i in range(nv))
    nchild = sum(1 for i in range(nb) if t.parent[i] >= 0)  # sums into a parent
    n = _fk_flops(t, inert=True)
    n += nb * (3 * _SV_ADD + 2 * _SV_CROSS + 2 * _INERTIA_MUL) + nchild * _SV_ADD
    n += nv * _SV_DOT  # C
    n += sum(2 * (t.neg_damping[d] != 0) + 3 * (t.neg_stiffness[d] != 0) + 2 for d in range(nv))
    n += nchild * 12 + sum(t.armature[d] != 0 for d in range(nv))
    n += sum(_INERTIA_MUL + _SV_DOT * sum(1 for e in range(d + 1) if root_path(t, t.dof_body[d]) >> e & 1)
             for d in range(nv))
    nfloor = nr - t.npair
    n += fact + solve + nfloor * (_M3_VEC + _V_ADD + _V_DOT + 4) + t.npair * _PAIR_CONTACT
    disks = [t.row_disk[r] for r in range(nfloor) if t.row_disk[r]]
    n += len(disks) * _DISK_RIM + sum(d == 2 for d in disks) * _V_CROSS
    if nr or nl:
        n += z_flops
        # the dofs a row's Jacobian touches: body a's root path, and for a
        # pair row body b's, less the dofs the two share
        masks = [root_path(t, t.row_body[r]) for r in range(nfloor)]
        masks += [root_path(t, t.pair_a[k]) ^ root_path(t, t.pair_b[k]) for k in range(t.npair)]
        ndofs = [bin(mask).count("1") for mask in masks]
        n += sum(k * (_V_CROSS + _V_ADD + 3 * _V_DOT) + 3 * rs for k, rs in zip(ndofs, rows_solve))
        n += lim_solve
        n += sum(3 * (2 * k + 2) + (1 if t.e_comb_zero else 2 * k + 4) + 2 for k in rows_len)
        if dense:
            n += sum(2 * k + 7 for k in lim_len)
            n += t.iterations * (sum(4 * 4 * k + 17 for k in rows_len)
                                 + sum(4 * k + 5 for k in lim_len))
        else:
            # the Gram entries (three dots a row); a limit row's |w|^2 and
            # inverse diagonal once a pair; a contact step's four dots, its
            # Gram corrections and three fused updates; a pair's one dot,
            # its second row's corrected dot and one update
            second = limit_pairs(t)
            n += sum(3 * 2 * k for k in rows_len)
            n += sum(3 if sec else 2 * k + 7 for k, sec in zip(lim_len, second))
            steps = [k for k, sec in zip(lim_len, second) if not sec]
            pairs = [k for k, sec in zip(lim_len[:-1], second[1:]) if sec]
            n += t.iterations * (sum(4 * 4 * k + 23 for k in rows_len)
                                 + sum(4 * k + 5 for k in steps) + 10 * len(pairs))
        n += 2 * back
    else:
        n += back + 2 * nv
    for i in range(nb):
        n += 6 + 2 * _M3_VEC + 6 + _QUAT_INTEGRATE if t.jtype[i] == int(JointType.FREE) else 3
    return n


def work_per_env_step(t, env_step: bool = True, dense: bool = False) -> Tuple[int, int]:
    """(float operations, bytes) that one env of one launch needs, for the
    tables `t`: `env_step_kernel`, or `physics_step_kernel` (`dense`: the
    default class's count before its root paths, `substep_flops`). Work that
    depends on the data is not counted: auto-reset draws, a new flag, a cube
    throw. Bytes count each input read once and each output written once;
    the tables once per launch are left to the caller."""
    n = t.frame_skip * substep_flops(t, dense)
    f32 = 4
    if not env_step:
        return n, f32 * (2 * t.nq + 2 * t.nv + t.nv + t.nr)
    na, kind = t.act, t.task_kind
    n += na  # the torques
    frames = t.nparts * (_M3_VEC + _V_ADD)
    if kind <= 2:  # walker_output
        n += _fk_flops(t, inert=False) + 3 * na + 3 * _ATAN2 + 4 + _V_CROSS + _V_ADD
        n += frames + 2 * t.nparts + 2 + 2 + _ATAN2 + 1 + 4 + 2 + 6 + 5 * na + 20
        if kind >= 1:  # the retarget test: the distance, the timer, dx and dy again
            n += 4 + 1 + 2
        if kind == 2:  # the cube's frame test, the get-up counter, leak and frame
            n += 1 + 1 + 2 + 1
    elif kind == 3:  # reacher_output: the potential, obs, electricity, stuck joint
        n += _fk_flops(t, inert=False) + frames + 3 + _V_DOT + 2 + 6 + 11 + 3 + 3
    elif kind <= 6:  # arm_output: the control cost, then each task's distances
        n += _fk_flops(t, inert=False) + frames + 2 * na + 1
        n += {4: 2 * (3 + _V_DOT + 2) + 6, 5: 3 * (3 + _V_DOT + 2) + 12, 6: 10}[kind]
    elif kind == 7:  # pendulum_output: cos, sin, the reward and the test
        n += 4
    elif kind == 8:  # the double pendulum: pole2's COM, four of cos/sin, the penalties
        n += _fk_flops(t, inert=False) + 4 + 14
    elif kind == 9:  # mj_walker_output: vx, the control cost, reward, comps, done
        n += 2 + 2 * na + 1 + 1 + 2 + 2 + 1
        if t.mj_free:  # MuJoCo's qvel: the root's rotation of the linear velocity
            n += _M3_FROM_QUAT + _M3_VEC + 1
        elif t.mj_clip_qvel:
            n += 2 * t.nv
        n += {0: 0, 1: 2 + (t.nq - 2 + t.nv), 2: 4, 3: 2, 4: 2}[t.mj_done]
    elif kind == 10:  # mj_reacher_output: tip - target, cos/sin, |d|, control cost
        n += _fk_flops(t, inert=False) + frames + 3 + 4 + _V_DOT + 2 + 2 * na + 1
    elif kind == 11:  # mj_pendulum_output: the test
        n += 2
    else:  # the double pendulum's tip: four of sin/cos, the penalties
        n += _fk_flops(t, inert=False) + frames + 4 + 1 + 14
    ins = f32 * (t.nq + t.nv + na + t.naux) + 2 + 4 * 4   # term, trunc, step, epoch, seed, id
    outs = f32 * (t.nq + t.nv + t.obs_dim + 1 + t.naux + t.ncomp) + 2 + 4 * 2
    return n, ins + outs


# ---------------------------------------------------------------------------
# host twin (CPU tests only)
# ---------------------------------------------------------------------------


def gxx_path() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    return gxx


def host_job(size: int = DEFAULT, caps: Optional[Tuple[int, ...]] = None,
             bf16_probe: bool = False):
    """The g++ job of the host twin's library of a class (engine_host.cpp;
    `HostTwin`), as `Builds` takes it, so that a caller can start it beside
    others."""
    flags = (GXX_FLAGS + (("-DENG_BF16_PROBE",) if bf16_probe else ())
             + class_flags(size, caps))
    h = _sources(["engine_core.h", "engine_host.cpp"])
    h.update(" ".join(flags).encode())
    return [gxx_path()], "engine_host.cpp", f"libengine_host_{h.hexdigest()[:16]}.so", flags


@functools.lru_cache(maxsize=None)
def _host_library(bf16_probe: bool, size: int, caps: Optional[Tuple[int, ...]] = None):
    job = host_job(size, caps, bf16_probe)
    _compile([job])
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, job[2]))
    _check_layout(lib, size, caps)
    lib.host_physics_step.argtypes = [_P] * 7 + [ctypes.c_int]
    lib.host_physics_step.restype = ctypes.c_int
    lib.host_env_step.argtypes = _ENV_ARGS
    lib.host_env_step.restype = ctypes.c_int
    lib.host_physics_scratch.argtypes = [_P] * 4 + [ctypes.c_int] * 2 + [_P]
    lib.host_physics_scratch.restype = ctypes.c_int
    lib.host_group_sums_take.restype = ctypes.c_longlong
    return lib


class HostTwin:
    """engine_core.h built with g++ for the host: the kernels' own C++
    arithmetic on CPU tensors, each env's lane group emulated at the tables'
    width (`tables.lanes`, any of LANE_WIDTHS), built with the tables' class
    (the large, huge and sized ones at their first use). Used only by tests
    and by
    tools/bf16_probe.py (`bf16_probe=True` builds it with ENG_BF16_PROBE);
    no wrapper routes here."""

    def __init__(self, bf16_probe: bool = False):
        self.bf16_probe = bf16_probe

    def _lib(self, tables):
        return _host_library(self.bf16_probe, tables_class(tables), tables_caps(tables))

    def physics_step(self, tables, q, v, tau):
        nq, B = q.shape
        n_rows = tables.nr
        outs = [torch.empty_like(q), torch.empty_like(v), torch.empty((n_rows, B))]
        for x, name in ((q, "q"), (v, "v"), (tau, "tau")):
            _check(x, name, torch.float32, x.shape, torch.device("cpu"))
        rc = self._lib(tables).host_physics_step(ctypes.addressof(tables),
                                                 *_ptrs([q, v, tau] + outs), B)
        _launch_checked(rc, "host physics step")
        return tuple(outs)

    def physics_scratch(self, tables, q, v, tau, env: int = 0) -> np.ndarray:
        """Env `env`'s scratch after its physics step (`tables.sc_stride`
        floats, laid out by `scratch_layout`): L, the forward-solved rows
        and the rest as the step leaves them (or, with `tables.stop_after`,
        as a substep leaves them where it stops)."""
        out = np.zeros(tables.sc_stride, np.float32)
        for x, name in ((q, "q"), (v, "v"), (tau, "tau")):
            _check(x, name, torch.float32, x.shape, torch.device("cpu"))
        rc = self._lib(tables).host_physics_scratch(
            ctypes.addressof(tables), *_ptrs([q, v, tau]), env, q.shape[-1],
            out.ctypes.data_as(_P))
        _launch_checked(rc, "host physics scratch")
        return out

    def group_sums(self, tables) -> int:
        """The butterflies (dependent group sums, `sweep_group_sums`) that
        the twin of the tables' class has run since this was last called."""
        return int(self._lib(tables).host_group_sums_take())

    def env_step(self, tables, task, state, action):
        ins, outs = _env_tensors(task, tables, state, action)
        rc = self._lib(tables).host_env_step(ctypes.addressof(tables), *_ptrs(ins + outs),
                                             state.q.shape[-1])
        _launch_checked(rc, "host env step")
        return _env_state(state, outs)
