"""Where a kernel's time goes, by phase, on the card.

    python3 pybulletgym_tpu_torch/tools/kernel_phases.py
        [--envs HalfCheetahPyBulletEnv-v0,...] [--batch 4096] [--lanes 8,16,32]
        [--root CHECKOUT]
    python3 pybulletgym_tpu_torch/tools/kernel_phases.py
        --scenes TwoHumanoids-v0:4096,FourHumanoids-v0:4096,balls40:1024
        [--kernels physics,task] [--calls 5,2]

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
batch after its colon. Besides the edits above, `rows0` (nr = nl = 0: no
contact or limit rows) leaves FK/RNE, the CRBA, the Cholesky, the dynamics
solve and the integration, so that rows = it0 - rows0 (the narrowphase, the
Jacobians, their forward solves, z and the PGS set-up) and dynamics = rows0
- fs0. In the large, huge and sized classes each edit is timed twice: with
the tables' tree blocks as packed (`tree`), and widened to one block over
all dofs (`dense`, `ops.cuda_engine.widen_blocks`): the dense loops'
arithmetic and storage, the same binary, so the two give a before and after
on one card. The outputs of the two are compared bit for bit
(`bitwise_to_dense`: q, v and the depths of the physics kernel, the state
of the task kernel, -0.0 and +0.0 told apart; `equal_to_dense`: the same
under torch.equal, which holds them equal).

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


def split(step, call, calls):
    """The edits' times of `step` launched by `call(step)`, and the phases."""
    rec = {}
    for name, field, value in EDITS:
        st = ce.with_tables(step, edited(step.tables, field, value))
        rec[name] = graph_ms(lambda: call(st), *calls)
    rec["sweeps_ms"] = rec["full"] - rec["it0"]
    rec["one_sweep_ms"] = rec["it1"] - rec["it0"]
    rec["rows_ms"] = rec["it0"] - rec["rows0"]
    rec["dynamics_ms"] = rec["rows0"] - rec["fs0"]
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
    env = make_batched(name, B)
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
    p.add_argument("--root", default=ROOT, help="the checkout whose package is timed")
    args = p.parse_args(argv)
    B = args.batch
    calls = tuple(int(x) for x in args.calls.split(","))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for item in [x for x in args.scenes.split(",") if x]:
        name, Bs = item.split(":")
        for kernel, (step, call) in scene_steps(name, int(Bs), args.kernels.split(","),
                                                dev).items():
            if hasattr(step, "prepare"):
                step.prepare(dev, int(Bs))
            tree = hasattr(step.tables, "dof_lo")
            rec = {"scene": name, "B": int(Bs), "kernel": step.kernel, "calls": calls,
                   "tree": split(step, call, calls)}
            rec["launch"] = (step.launch_config(dev, int(Bs)) if kernel == "task" else
                             ce.launch_config(step.tables, "physics_step_kernel", int(Bs)))
            if tree:
                dense = ce.with_tables(step, ce.widen_blocks(step.tables))
                rec["dense"] = split(dense, call, calls)
                rec["dense_launch"] = (dense.launch_config(dev, int(Bs)) if kernel == "task" else
                                       ce.launch_config(dense.tables, "physics_step_kernel",
                                                        int(Bs)))
                x, y = call(step), call(dense)
                rec["bitwise_to_dense"] = same(x, y)
                rec["equal_to_dense"] = same(x, y, bits=False)
                rec["speedup"] = rec["dense"]["full"] / rec["tree"]["full"]
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
