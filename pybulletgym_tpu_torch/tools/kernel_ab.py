"""A/B timing of the two CUDA kernels across checkouts of this repository.

    python3 pybulletgym_tpu_torch/tools/kernel_ab.py ROOT_A ROOT_B [ROOT ...]
        [--envs HalfCheetahPyBulletEnv-v0,AntPyBulletEnv-v0] [--batch 4096]
        [--rounds 2] [--lanes 2,4,8,16,32]

Each round runs every root once, forwards then backwards (A B B A for two
roots and two rounds), so that drift of the card over the call shows up
as a symmetric pattern. For each root a fresh process imports that
checkout's `pybulletgym_tpu_torch` (PYTHONPATH=ROOT), builds its kernels,
and times `env_step_kernel` (`BatchedEnv.step_fn`) and
`physics_step_kernel` (`make_cuda_physics_step`) per env id with CUDA
events: 50 launches after 5 warm-ups ("ms": host time between launches
included, which bounds the small models), and 20 launches captured in a
CUDA graph and replayed 3 times ("graph_ms": the device's time a launch),
on a post-reset state and random actions in [-1, 1]. It prints one JSON line per (root, env, kernel), then
the card's name and power limit; where the checkout counts its kernels'
work (`cuda_engine.work_per_env_step`), each line also carries the bound
that count gives ("bound_ms": operations over 67 TFLOP/s or bytes over 3.35
TB/s, the larger, "bound_by"), so that two checkouts' counts sit side by
side, and where it has `cuda_engine.launch_config`, the launch ("launch":
G, envs a block, shared bytes, resident blocks an SM). Needs one CUDA GPU; uses only entry points that every slice of the
port has.

Besides the shipped IDs, --envs takes the scenes of chip_smoke.py by ID
(`TwoHumanoids-v0`, `FourHumanoids-v0`, `TenHumanoids-v0`: registered from
the checkout's own `chip_smoke.humanoids_task`; their step is
`task_step_kernel`, its line named by its build) and `ballsN`, N free balls
on the floor (`chip_smoke.balls_xml`; the physics kernel only, from qpos0
with random velocities and torques): the large, huge and sized builds.

--lanes times a checkout with lane-group kernels (`cuda_engine.LANE_WIDTHS`)
once per listed group width G, overriding the width that `pick_lanes`
chooses (the line's "lanes"; "lanes": null is the checkout's own choice);
a width whose library holds fewer dofs than the model (`cuda_engine.lane_nv`)
prints a "skipped" line; checkouts without lane groups are timed once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys, torch
from pybulletgym_tpu_torch import make_batched, make_task
from pybulletgym_tpu_torch.ops import cuda_engine as ce

def ms(fn, n=50, warm=5):
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n

def graph_ms(fn, n=20, reps=3):
    # device ms a call with no host time between launches: n calls
    # captured in one CUDA graph, replayed reps times
    for _ in range(3):
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

def bound(t, name):
    # the least time of the launch's work on an H100 (67 TFLOP/s float32,
    # 3.35 TB/s): each env's operations and bytes, the tables once
    import ctypes
    flops, nbytes = ce.work_per_env_step(t, env_step=name == "env_step_kernel")
    t_ops, t_bytes = flops * B / 67e12 * 1e3, (nbytes * B + ctypes.sizeof(t)) / 3.35e12 * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

def task_bound(st, reset_share):
    # task_step_kernel's bound: the hooks' operations beside the substeps'
    import ctypes
    from pybulletgym_tpu_torch.ops import task_kernel as tk
    flops, nbytes = tk.work_per_task_step(st.tables, st.program, reset_share)
    t_ops, t_bytes = flops * B / 67e12 * 1e3, (nbytes * B + ctypes.sizeof(st.tables)) / 3.35e12 * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

def balls(n):
    # n free balls on the floor (the root's chip_smoke.balls_xml): the physics kernel alone
    import numpy as np
    from pybulletgym_tpu_torch.models.mjcf import parse_mjcf
    from pybulletgym_tpu_torch.ops.step import PhysicsConfig
    m = parse_mjcf(cs.balls_xml(n, 0.09), "balls")
    phys = ce.make_cuda_physics_step(m, PhysicsConfig())[0]
    q = torch.as_tensor(np.repeat(m.qpos0[:, None], B, 1), dtype=torch.float32, device=dev)
    v = torch.rand((m.nv, B), device=dev, generator=g) - 0.5
    tau = torch.rand((m.nv, B), device=dev, generator=g) * 2 - 1
    fn = lambda: phys(q, v, tau)
    fn()
    rec = {"root": root, "env": f"balls{n}", "kernel": phys.kernel, "B": B, "lanes": None,
           "ms": ms(fn), "graph_ms": graph_ms(fn)}
    rec.update(bound(phys.tables, "physics_step_kernel"))
    rec["launch"] = ce.launch_config(phys.tables, "physics_step_kernel", B)
    rec["scratch_bytes_per_env"] = 4 * phys.tables.sc_stride
    print(json.dumps(rec), flush=True)

root, B, envs = sys.argv[1], int(sys.argv[2]), sys.argv[3].split(",")
widths = [int(x) for x in sys.argv[4].split(",")] if sys.argv[4] else []
if not hasattr(ce, "LANE_WIDTHS"):
    widths = []
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
# the scenes of chip_smoke.py by ID: copies of humanoid.xml in one worldbody
SCENES = {"TwoHumanoids-v0": 2, "FourHumanoids-v0": 4, "TenHumanoids-v0": 10}
if any(e in SCENES or e.startswith("balls") for e in envs):
    import pybulletgym_tpu_torch as pt
    sys.path.insert(0, root)
    import chip_smoke as cs
for env_id in envs:
    if env_id.startswith("balls"):
        balls(int(env_id[5:]))
        continue
    if env_id in SCENES:
        n = SCENES[env_id]
        pt.register(env_id, lambda n=n: cs.humanoids_task(cs.humanoids_xml(n), n), 1000)
    task = make_task(env_id)
    env = make_batched(env_id, B)
    s = env.reset(seed=0)
    a = torch.rand((task.act_dim, B), device=dev, generator=g) * 2 - 1
    phys = ce.make_cuda_physics_step(task.model, task.physics)[0]
    zero = torch.zeros(B, device=dev)  # the task's torques (action_tau_scalar)
    tau = torch.stack([zero if isinstance(x, float) else x
                       for x in task.action_tau_scalar(list(torch.clamp(a, -1.0, 1.0)))], 0)
    step_kernel = getattr(env.step_fn, "kernel", "env_step_kernel")
    for lanes in widths or [None]:
        if lanes is not None and hasattr(ce, "lane_nv") and task.model.nv > ce.lane_nv(lanes):
            print(json.dumps({"root": root, "env": env_id, "B": B, "lanes": lanes,
                              "skipped": f"{task.model.nv} dofs exceed lane_nv({lanes})"}), flush=True)
            continue
        if lanes is not None:
            env.step_fn.tables.lanes = phys.tables.lanes = lanes
        for name, fn in ((step_kernel, lambda: env.step_fn(s, a)),
                         ("physics_step_kernel", lambda: phys(s.q, s.v, tau))):
            rec = {"root": root, "env": env_id, "kernel": name, "B": B, "lanes": lanes,
                   "ms": ms(fn), "graph_ms": graph_ms(fn)}
            task_step = name.startswith("task_step_kernel")
            if name == "physics_step_kernel":
                rec["kernel"] = getattr(phys, "kernel", name)
            if task_step:
                rec.update(task_bound(env.step_fn, 0.0))
                rec["launch"] = env.step_fn.launch_config(dev, B)
            elif hasattr(ce, "work_per_env_step"):
                rec.update(bound(env.step_fn.tables if name == "env_step_kernel" else phys.tables,
                                 name))
            if not task_step and (lanes is not None or hasattr(ce, "launch_config")):
                t = env.step_fn.tables if name == "env_step_kernel" else phys.tables
                rec["launch"] = ce.launch_config(t, name, B)
            t = env.step_fn.tables if name != "physics_step_kernel" else phys.tables
            rec["scratch_bytes_per_env"] = 4 * t.sc_stride
            print(json.dumps(rec), flush=True)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--envs", default="HalfCheetahPyBulletEnv-v0,AntPyBulletEnv-v0")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--lanes", default="", help="group widths to time, e.g. 2,4,8,16,32")
    args = p.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    order = []
    for k in range(args.rounds):
        order += roots if k % 2 == 0 else roots[::-1]
    for root in order:
        env = dict(os.environ, PYTHONPATH=root)
        subprocess.run([sys.executable, "-c", _CHILD, root, str(args.batch), args.envs,
                        args.lanes],
                       cwd=root, env=env, check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "order": order}), flush=True)


if __name__ == "__main__":
    main()
