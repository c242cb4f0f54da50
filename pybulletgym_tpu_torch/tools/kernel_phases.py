"""Where a kernel's time goes, by phase, on the card.

    python3 pybulletgym_tpu_torch/tools/kernel_phases.py
        [--envs HalfCheetahPyBulletEnv-v0,...] [--batch 4096] [--lanes 8,16,32]
        [--root CHECKOUT]
    python3 pybulletgym_tpu_torch/tools/kernel_phases.py
        --scenes TwoHumanoids-v0:4096,FourHumanoids-v0:4096,balls40:1024
        [--kernels physics,task] [--calls 5,2] [--words 3,8]

For each env id (`--envs`) it times `env_step_kernel` (graph-replayed
launches, CUDA events, as kernel_ab.py's "graph_ms") on a post-reset state
and random actions, with the launch's tables changed one field at a time:

  * as packed (`full`);
  * `iterations` = 0 and 1: the PGS sweeps' share, and one sweep's cost;
  * `frame_skip` = 0: the launch without substeps (inputs, the task's
    outputs, the writes).

  * `rows0` (nr = nl = 0: no contact or limit rows, as below);
  * where the tables have `stop_after` (the default class over root paths,
    engine_core.h · ENG_PATH_FIELDS), `stop_after` = 1, 2 and 3: each
    substep returns after FK, RNE and the composite inertias (one lane),
    after the CRBA rows and the narrowphase, after the factorization of M.

From these: sweeps = full - it0, rest of the substeps = it0 - fs0, rows =
it0 - rows0 (the narrowphase, the Jacobians, their forward solves, z, the
PGS set-up and the second back substitution), dynamics = rows0 - fs0, and
outputs = fs0; with the stops, FK/RNE = stop1 - fs0, CRBA = stop2 - stop1
(with the narrowphase), factorization = stop3 - stop2. --lanes repeats it
at each listed group width G in place of `pick_lanes`'s. --root times the
package of another checkout (its kernels built from its sources) with this
script, for a before and after on one card.

`--scenes` splits `physics_step_kernel` and `task_step_kernel` in the build
of a scene's size class instead: a multi-Humanoid scene by ID (the IDs of
chip_smoke.py, `TwoHumanoids-v0`, `FourHumanoids-v0`, `TenHumanoids-v0`,
registered here from its `humanoids_task`), the physics kernel from the
ID's reset state and torques, the task kernel by `make_batched(id, B)`; or
`ballsN`, N free balls (`chip_smoke.balls_xml`), physics only; each at the
batch after its colon. The same edits and phases as above: `rows0` (nr = nl
= 0: no contact or limit rows) leaves FK/RNE, the CRBA, the factorization,
the dynamics solve and the integration, so that rows = it0 - rows0 (the
narrowphase, the Jacobians, their forward solves, z and the PGS set-up) and
dynamics = rows0 - fs0, split by the stops where the tables have
`stop_after` (every class since the large, huge and sized ones run the
default class's substep; a checkout before that, --root, has them in the
default class only). --root with --scenes splits the scenes in another
checkout's builds, for a before and after on one card. `--words` splits
each scene's physics kernel again with its tables moved into the sized
class of its own caps but W root-path mask words (NV = 32 W:
`in_words`), for each W listed that holds its dofs: the same model, rows
and arithmetic, only
the width of the dof sets and records changed, so that what the mask
words cost each phase reads apart from the rest.

The arithmetic of a launch with changed tables is not the model's; only
its time is read. Prints one JSON line per env or scene and kernel, then
the card's name and power limit. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the checkout whose package is timed: --root's, else this file's
PKG_ROOT = (os.path.abspath(sys.argv[sys.argv.index("--root") + 1]) if "--root" in sys.argv
            else ROOT)
sys.path.insert(0, PKG_ROOT)
from pybulletgym_tpu_torch import make_batched, make_task  # noqa: E402
from pybulletgym_tpu_torch.ops import cuda_engine as ce  # noqa: E402

SCENE_HUMANOIDS = {"TwoHumanoids-v0": 2, "FourHumanoids-v0": 4, "TenHumanoids-v0": 10}


def graph_ms(fn, n=20, reps=3):
    """Device ms a call: n calls captured in one CUDA graph, replayed."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def edited(t, field, value):
    e = type(t).from_buffer_copy(t)
    if field == "rows":
        e.nr = e.nl = 0
    elif field is not None:
        setattr(e, field, value)
    return e


EDITS = (("full", None, None), ("it0", "iterations", 0), ("it1", "iterations", 1),
         ("rows0", "rows", 0), ("fs0", "frame_skip", 0))
STOPS = (("stop1", "stop_after", 1), ("stop2", "stop_after", 2), ("stop3", "stop_after", 3))


def split(step, call, calls, stops=()):
    """The edits' (and `stops`') times of `step` launched by `call(step)`,
    and the phases."""
    rec = {}
    for name, field, value in EDITS + stops:
        st = ce.with_tables(step, edited(step.tables, field, value))
        rec[name] = graph_ms(lambda: call(st), *calls)
    rec["sweeps_ms"] = rec["full"] - rec["it0"]
    rec["one_sweep_ms"] = rec["it1"] - rec["it0"]
    rec["rows_ms"] = rec["it0"] - rec["rows0"]
    rec["dynamics_ms"] = rec["rows0"] - rec["fs0"]
    if stops:
        rec["fk_rne_ms"] = rec["stop1"] - rec["fs0"]
        rec["crba_narrowphase_ms"] = rec["stop2"] - rec["stop1"]
        rec["factorization_ms"] = rec["stop3"] - rec["stop2"]
    rec["substeps_without_sweeps_ms"] = rec["it0"] - rec["fs0"]
    rec["outside_substeps_ms"] = rec["fs0"]
    return rec


def scene_steps(name, B, kernels, dev):
    """{kernel: (wrapper, call)} of a scene, its wrappers prepared for B envs."""
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    import pybulletgym_tpu_torch as pt
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    if name.startswith("balls"):
        m = parse_mjcf(cs.balls_xml(int(name[5:]), 0.09), "balls")
        phys = ce.make_cuda_physics_step(m, PhysicsConfig())[0]
        q = torch.as_tensor(np.repeat(m.qpos0[:, None], B, 1), dtype=torch.float32, device=dev)
        v = torch.rand((m.nv, B), device=dev, generator=g) - 0.5
        tau = torch.rand((m.nv, B), device=dev, generator=g) * 2 - 1
        out["physics"] = (phys, lambda st: st(q, v, tau))
        return out
    n = SCENE_HUMANOIDS[name]
    xml = cs.humanoids_xml(n)
    pt.register(name, lambda: cs.humanoids_task(xml, n), 1000)
    task = make_task(name)
    # the composed backend's reset (the fused one's bits) builds no task kernel
    env = make_batched(name, B, **({} if "task" in kernels else {"backend": "composed"}))
    s = env.reset(seed=0)
    a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
    if "task" in kernels:
        out["task"] = (env.step_fn, lambda st: st(s, a))
    if "physics" in kernels:
        phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
        tau = torch.zeros((task.model.nv, B), device=dev)
        tau[task.act_dofs] = torch.tensor(task.gears, device=dev)[:, None] * a
        out["physics"] = (phys, lambda st: st(s.q, s.v, tau))
    return out


def in_words(step, words):
    """A copy of the physics wrapper `step` whose tables are its own in the
    sized class of the model's caps (`ce.sized_caps`) with NV = 32 `words`
    (and a draw for every dof): `words` root-path mask words."""
    t = step.tables
    caps = list(ce.sized_caps(t.nb, t.nq, t.nv, t.nr, t.npair, t.nl, t.act))
    caps[1] = 32 * words
    caps[6], caps[8] = max(caps[6], caps[1]), max(caps[8], caps[1])
    other = ce.with_tables(step, ce.tables_in_class(t, ce.SIZED, tuple(caps)))
    other.size, other.caps = ce.SIZED, tuple(caps)
    other.kernel = "physics_step_kernel" + ce.KERNEL_SUFFIX[ce.SIZED]
    return other


def same(a, b, bits=True):
    """Two physics outputs (q, v, depths) or two EnvStates' arrays equal bit
    for bit (`bits`), or under torch.equal."""
    if hasattr(a, "q"):
        a, b = ([getattr(x, k) for k in ("q", "v", "obs", "reward", "terminated", "truncated",
                                         "step_count", "epoch")] for x in (a, b))
    if not bits:
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", default="HalfCheetahPyBulletEnv-v0,AntPyBulletEnv-v0,"
                   "HumanoidPyBulletEnv-v0,HumanoidFlagrunHarderPyBulletEnv-v0")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lanes", default="", help="group widths, e.g. 8,16,32")
    p.add_argument("--scenes", default="", help="scene:B,... (FourHumanoids-v0:4096, balls40:1024)")
    p.add_argument("--kernels", default="physics,task", help="a scene's kernels")
    p.add_argument("--calls", default="20,3", help="graph-captured calls, replays")
    p.add_argument("--words", default="", help="a scene's physics kernel again at these "
                   "mask words, e.g. 3,8")
    p.add_argument("--root", default=ROOT, help="the checkout whose package is timed")
    args = p.parse_args(argv)
    B = args.batch
    calls = tuple(int(x) for x in args.calls.split(","))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    words = [int(x) for x in args.words.split(",") if x]
    scenes = []
    for item in [x for x in args.scenes.split(",") if x]:
        name, Bs = item.split(":")
        steps = scene_steps(name, int(Bs), args.kernels.split(","), dev)
        if "physics" in steps:
            phys, call = steps["physics"]
            steps.update({f"physics@{w}": (in_words(phys, w), call) for w in words
                          if 32 * w >= phys.tables.nv})
        scenes.append((name, Bs, steps))
    # every physics library at once, one nvcc a group width and class
    ce.Builds(list({job[2]: job for _, _, steps in scenes for kernel, (st, _) in steps.items()
                    if kernel.startswith("physics")
                    for job in ce._engine_jobs(st.size, st.caps)[0]}.values())).wait()
    for name, Bs, steps in scenes:
        for kernel, (step, call) in steps.items():
            if hasattr(step, "prepare"):
                step.prepare(dev, int(Bs))
            stops = STOPS if hasattr(step.tables, "stop_after") else ()
            rec = {"scene": name, "B": int(Bs), "kernel": step.kernel, "calls": calls,
                   "root": args.root, "scratch_bytes_per_env": 4 * step.tables.sc_stride,
                   "mask_words": ce.tables_type(ce.tables_class(step.tables), ce.tables_caps(
                       step.tables))[1]["MASK_WORDS"], **split(step, call, calls, stops)}
            rec["launch"] = (step.launch_config(dev, int(Bs)) if kernel == "task" else
                             ce.launch_config(step.tables, "physics_step_kernel", int(Bs)))
            print(json.dumps(rec), flush=True)
    for env_id in [x for x in args.envs.split(",") if x and not args.scenes]:
        task = make_task(env_id)
        env = make_batched(env_id, B)
        s = env.reset(seed=0)
        a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
        step = env.step_fn
        for lanes in [int(x) for x in args.lanes.split(",") if x] or [None]:
            packed = ce.pack_tables(task)
            if lanes is not None:
                packed.lanes = lanes
            rec = {"env": env_id, "B": B, "lanes": packed.lanes, "root": args.root,
                   "frame_skip": packed.frame_skip, "iterations": packed.iterations,
                   "launch": ce.launch_config(packed, "env_step_kernel", B)}
            stops = STOPS if hasattr(packed, "stop_after") else ()
            for name, field, value in EDITS + stops:
                e = edited(packed, field, value)
                ctypes.memmove(ctypes.addressof(step.tables), ctypes.addressof(e),
                               ctypes.sizeof(e))
                rec[name] = graph_ms(lambda: step(s, a), *calls)
            rec["sweeps_ms"] = rec["full"] - rec["it0"]
            rec["one_sweep_ms"] = rec["it1"] - rec["it0"]
            rec["rows_ms"] = rec["it0"] - rec["rows0"]
            rec["dynamics_ms"] = rec["rows0"] - rec["fs0"]
            if stops:
                rec["fk_rne_ms"] = rec["stop1"] - rec["fs0"]
                rec["crba_narrowphase_ms"] = rec["stop2"] - rec["stop1"]
                rec["factorization_ms"] = rec["stop3"] - rec["stop2"]
            rec["substeps_without_sweeps_ms"] = rec["it0"] - rec["fs0"]
            rec["outside_substeps_ms"] = rec["fs0"]
            print(json.dumps(rec), flush=True)
        ctypes.memmove(ctypes.addressof(step.tables), ctypes.addressof(ce.pack_tables(task)),
                       ctypes.sizeof(packed))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
